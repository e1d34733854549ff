"""Typed configuration of the whole engine, and its OpenCV-YAML reader.

Pure-Python copies of the dataclasses and the reader of
`orbslam2_nmi_tpu/config.py`, kept in this package so that the port imports
nothing of the JAX package. They mirror every knob of the reference's two
config layers: the per-dataset OpenCV YAML (``Camera.*``, ``ORBextractor.*``,
``Viewer.*``, ``NMI.*``; reference: Examples/Monocular/ETH_small.yaml) and the
compile-time ``#define``s (Thirdparty/Localization/allProperties.hpp:27-50).
The OpenCV-YAML dialect (``%YAML:1.0`` header, ``!!opencv-matrix`` blocks,
``key:value`` without a space) is parsed by a small hand-rolled reader, so
nothing depends on cv2.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics + distortion (reference: ETH_small.yaml:8-24)."""

    fx: float = 435.04593205
    fy: float = 435.04593205
    cx: float = 475.55781765
    cy: float = 274.7487729
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: int = 1
    width: int = 960
    height: int = 540

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor budget (reference: ETH_small.yaml:30-43, ORBextractor.cc:1048)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Implementation constants shared with the reference extractor
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19
    cell_size: int = 30  # FAST is run per 30px cell (ORBextractor.cc:770)

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    @property
    def inv_scale_factors(self) -> np.ndarray:
        return 1.0 / self.scale_factors

    def features_per_level(self) -> np.ndarray:
        """Geometric feature budget per pyramid level (ORBextractor.cc:1048 behavior)."""
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1.0 - factor) / (1.0 - factor**self.n_levels)
        per_level = []
        total = 0
        for _ in range(self.n_levels - 1):
            n = int(round(n_desired))
            per_level.append(n)
            total += n
            n_desired *= factor
        per_level.append(max(self.n_features - total, 0))
        return np.array(per_level, dtype=np.int32)


@dataclass(frozen=True)
class NMIGridConfig:
    """6-DoF search-grid descriptor (reference: ETH_small.yaml:77-88,
    Thirdparty/Localization/nmiSearchKernel.hpp:25-86)."""

    synth_num: tuple[int, int, int] = (3, 3, 3)  # translations (X, Y, Z)
    warp_num: tuple[int, int, int] = (3, 3, 3)  # rotations (X, Y, Z)
    synth_step: tuple[float, float, float] = (0.2, 0.2, 0.5)  # meters
    warp_step: tuple[float, float, float] = (0.02, 0.02, 0.05)  # radians


@dataclass(frozen=True)
class NMIConfig:
    """NMI localization stage (reference: ETH_small.yaml:62-96, allProperties.hpp:27-50)."""

    init1: Optional[np.ndarray] = None  # 4x4 Twc for frame 0 (NMI.Init1)
    init2: Optional[np.ndarray] = None  # 4x4 Twc for frame `offset` (NMI.Init2)
    offset: int = 10  # second init frame index (NMI.Offset)
    threshold: float = 0.1  # accept threshold ("NMI.Treshold" in the yaml)
    grid: NMIGridConfig = field(default_factory=NMIGridConfig)
    # Renderer
    render_point_size: float = 3.0
    render_near: float = 5.0
    render_far: float = 30.0
    model_obj_path: str = ""
    model_texture_path: str = ""
    model_cloud_path: str = ""
    model_offset_path: str = ""
    render_mode: int = 1  # 1 = textured mesh, 4 = pointcloud (allProperties.hpp:41)
    # allProperties.hpp equivalents
    max_iteration_count: int = 4  # nmi_prop_MAX_ITERATION_COUNT
    reloc_frequency: int = 2  # nmi_prop_RELOC_FREQUENCY (every 2nd KF)
    step_factor: float = 0.5  # nmi_prop_STEPFACTOR
    use_background: bool = True  # nmi_prop_BG
    # >1: run all but the final search iteration at 1/coarse_scale resolution
    # (the final iteration and the accept gate are always full-resolution).
    # 1 = reference behavior (every sweep full-res).
    coarse_scale: int = 1
    min_kernel_rotation: float = 0.001  # rad (nmi_prop_MIN_KERNEL_ROTATION)
    min_kernel_translation: float = 0.005  # m (nmi_prop_MIN_KERNEL_TRANSLATION)
    # Score metric: "SUC" = 2(1 - Hab/(Ha+Hb)), "ENMI" = (Ha+Hb)/Hab
    # (reference: kernel.cuh:22-23; SUC is the enabled variant, NMI.cu:344-359)
    metric: str = "SUC"
    n_bins: int = 256
    # Search-window sizing: steps = drift_fraction * |motion since last NMI| per axis
    # (reference: Tracking.cc:2001-2010; 2% window for ~1% assumed drift)
    drift_fraction: float = 0.02
    # Gain termination: stop when best/prev < gain_epsilon twice (Tracking.cc:2108-2121)
    gain_epsilon: float = 1.001


@dataclass(frozen=True)
class ViewerConfig:
    """Viewer knobs (reference: ETH_small.yaml:48-57). Headless replay only."""

    keyframe_size: float = 0.1
    keyframe_line_width: float = 1.0
    graph_line_width: float = 1.0
    point_size: float = 2.0
    camera_size: float = 0.15
    camera_line_width: float = 2.0
    viewpoint: tuple[float, float, float] = (0.0, -10.0, -0.1)
    viewpoint_f: float = 2000.0


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking heuristics preserved from the reference pipeline."""

    # Matcher thresholds (ORBmatcher.cc:42-44)
    th_low: int = 50
    th_high: int = 100
    hist_length: int = 30  # rotation histogram bins (ORBmatcher.cc:45)
    nn_ratio_tracking: float = 0.9
    # Pose optimization (Optimizer.cc:251): 4 rounds x 10 LM iterations
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    chi2_mono: float = 5.991
    # Keyframe decision (Tracking.cc:1217)
    min_frames: int = 0
    max_frames: int = 30  # = fps
    # Local BA (Optimizer.cc:472): 5 then 10 iterations
    local_ba_iters1: int = 5
    local_ba_iters2: int = 10
    # Map capacities (fixed-shape SoA arrays)
    max_keyframes: int = 2048
    max_map_points: int = 65536
    max_features: int = 2048  # per frame (>= ORBConfig.n_features)
    # Frame feature grid (Frame.cc:234: 64x48 cells)
    grid_cols: int = 64
    grid_rows: int = 48


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    nmi: NMIConfig = field(default_factory=NMIConfig)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    vocabulary_path: str = ""
    output_dir: str = "results"

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# OpenCV-YAML reader
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce(value: str):
    value = value.strip().strip('"')
    if _NUM_RE.match(value):
        f = float(value)
        return int(f) if f.is_integer() and "." not in value and "e" not in value.lower() else f
    return value


def parse_opencv_yaml(text: str) -> dict:
    """Parse the OpenCV YAML dialect used by the reference settings files.

    Handles ``%YAML:1.0``, comments, ``key: value`` and ``key:value`` scalars, and
    multi-line ``!!opencv-matrix`` blocks (returned as np.ndarray). This mirrors what
    ``cv::FileStorage`` reads in Tracking.cc:120 / localization.cpp:131.
    """
    out: dict = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        i += 1
        if not line.strip() or line.startswith("%YAML"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.*)$", line.strip())
        if not m:
            continue
        key, rest = m.group(1), m.group(2).strip()
        if rest == "!!opencv-matrix":
            block: dict = {}
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].strip()
                if not sub:
                    i += 1
                    continue
                sm = re.match(r"^(rows|cols|dt|data)\s*:\s*(.*)$", sub)
                if not sm:
                    break
                i += 1
                k2, v2 = sm.group(1), sm.group(2).strip()
                if k2 == "data":
                    while not v2.rstrip().endswith("]") and i < len(lines):
                        v2 += " " + lines[i].strip()
                        i += 1
                    nums = re.findall(r"[+-]?\d+\.?\d*(?:[eE][+-]?\d+)?", v2)
                    block["data"] = [float(x) for x in nums]
                else:
                    block[k2] = _coerce(v2)
            rows, cols = int(block.get("rows", 0)), int(block.get("cols", 0))
            arr = np.array(block.get("data", []), dtype=np.float32)
            out[key] = arr.reshape(rows, cols) if rows and cols else arr
        else:
            out[key] = _coerce(rest)
    return out


def load_yaml_config(path: str) -> SystemConfig:
    """Build a SystemConfig from a reference-format settings YAML."""
    with open(path, "r") as f:
        d = parse_opencv_yaml(f.read())

    cam = CameraConfig(
        fx=d.get("Camera.fx", CameraConfig.fx),
        fy=d.get("Camera.fy", CameraConfig.fy),
        cx=d.get("Camera.cx", CameraConfig.cx),
        cy=d.get("Camera.cy", CameraConfig.cy),
        k1=d.get("Camera.k1", 0.0),
        k2=d.get("Camera.k2", 0.0),
        p1=d.get("Camera.p1", 0.0),
        p2=d.get("Camera.p2", 0.0),
        k3=d.get("Camera.k3", 0.0),
        fps=float(d.get("Camera.fps", 30.0)),
        rgb=int(d.get("Camera.RGB", 1)),
        width=int(d.get("Camera.Width", 960)),
        height=int(d.get("Camera.Height", 540)),
    )
    orb = ORBConfig(
        n_features=int(d.get("ORBextractor.nFeatures", 2000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
    )
    grid = NMIGridConfig(
        synth_num=(
            int(d.get("NMI.SynthNumX", 3)),
            int(d.get("NMI.SynthNumY", 3)),
            int(d.get("NMI.SynthNumZ", 3)),
        ),
        warp_num=(
            int(d.get("NMI.WarpNumX", 3)),
            int(d.get("NMI.WarpNumY", 3)),
            int(d.get("NMI.WarpNumZ", 3)),
        ),
        synth_step=(
            float(d.get("NMI.SynthStepX", 0.2)),
            float(d.get("NMI.SynthStepY", 0.2)),
            float(d.get("NMI.SynthStepZ", 0.5)),
        ),
        warp_step=(
            float(d.get("NMI.WarpStepX", 0.02)),
            float(d.get("NMI.WarpStepY", 0.02)),
            float(d.get("NMI.WarpStepZ", 0.05)),
        ),
    )
    nmi = NMIConfig(
        init1=d.get("NMI.Init1"),
        init2=d.get("NMI.Init2"),
        offset=int(d.get("NMI.Offset", 10)),
        threshold=float(d.get("NMI.Treshold", 0.1)),
        grid=grid,
        render_point_size=float(d.get("NMI.Render.PointSize", 3.0)),
        render_near=float(d.get("NMI.Render.NearPlane", 5.0)),
        render_far=float(d.get("NMI.Render.FarPlane", 30.0)),
        model_obj_path=str(d.get("NMI.Render.Object", "")),
        model_texture_path=str(d.get("NMI.Render.Texture", "")),
        model_cloud_path=str(d.get("NMI.Render.Cloud", "")),
        model_offset_path=str(d.get("NMI.Render.Offset", "")),
    )
    viewer = ViewerConfig(
        keyframe_size=float(d.get("Viewer.KeyFrameSize", 0.1)),
        keyframe_line_width=float(d.get("Viewer.KeyFrameLineWidth", 1.0)),
        graph_line_width=float(d.get("Viewer.GraphLineWidth", 1.0)),
        point_size=float(d.get("Viewer.PointSize", 2.0)),
        camera_size=float(d.get("Viewer.CameraSize", 0.15)),
        camera_line_width=float(d.get("Viewer.CameraLineWidth", 2.0)),
        viewpoint=(
            float(d.get("Viewer.ViewpointX", 0.0)),
            float(d.get("Viewer.ViewpointY", -10.0)),
            float(d.get("Viewer.ViewpointZ", -0.1)),
        ),
        viewpoint_f=float(d.get("Viewer.ViewpointF", 2000.0)),
    )
    tracking = TrackingConfig(max_frames=int(round(cam.fps)))
    return SystemConfig(camera=cam, orb=orb, nmi=nmi, viewer=viewer, tracking=tracking)
