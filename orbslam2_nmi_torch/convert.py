"""Carry the JAX package's state into the port.

The two packages share no objects; state passes between them as numpy arrays
and plain dicts: the binned mesh (the JAX `BinnedMesh` built with
`device_arrays=False`, whose fields are numpy arrays and Python scalars), the
point-splat render model, the configurations (the `dataclasses.asdict` of
the JAX dataclasses) and the tracking step's carry, so that both packages
render, score, search and track with the same state in the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch import config
from orbslam2_nmi_torch.io.model_loader import PointCloudModel
from orbslam2_nmi_torch.ops import raster, render
from orbslam2_nmi_torch.slam.fused_track import TrackCarry

_DTYPES = {
    "tri_data": np.float32, "tri_ids": np.int32, "verts": np.float32, "uvs": np.float32,
    "faces": np.int32, "texture": np.float32,
}


def binned_from_numpy(fields: dict, device: str | torch.device = "cuda") -> raster.BinnedMesh:
    """The port's BinnedMesh, on `device`, from a dict of the reference's
    BinnedMesh fields (numpy arrays and scalars, e.g. `binned._asdict()`).
    The reference's texture windows are not carried: the port's sampler reads
    the whole texture, which gives the same images."""
    missing = set(raster.BinnedMesh._fields) - set(fields)
    if missing:
        raise ValueError(f"binned-mesh fields missing: {sorted(missing)}")
    kw = {k: fields[k] for k in raster.BinnedMesh._fields}
    for k, dt in _DTYPES.items():
        kw[k] = np.asarray(kw[k], dt)
    kw["tex_hw"] = tuple(int(x) for x in kw["tex_hw"])
    for k in ("tiles_y", "tiles_x", "height", "width", "capacity", "overflow"):
        kw[k] = int(kw[k])
    return raster.to_device(raster.BinnedMesh(**kw), device)


def render_model_from_numpy(points, gray, device: str | torch.device = "cuda") -> render.RenderModel:
    """The port's point-splat RenderModel, on `device`, from the reference's
    `RenderModel` fields (e.g. `np.asarray(model.points)`, `np.asarray(model.gray)`)."""
    return render.model_from_pointcloud(
        PointCloudModel(points=np.asarray(points), gray=np.asarray(gray)), device)


def camera_config_from_dict(d: dict) -> config.CameraConfig:
    """The port's CameraConfig from `dataclasses.asdict` of the reference's."""
    return config.CameraConfig(**d)


def nmi_config_from_dict(d: dict) -> config.NMIConfig:
    """The port's NMIConfig from `dataclasses.asdict` of the reference's (its
    `grid` a nested dict)."""
    grid = {k: tuple(v) for k, v in d["grid"].items()}
    return config.NMIConfig(**{**d, "grid": config.NMIGridConfig(**grid)})


def system_config_from_dict(d: dict) -> config.SystemConfig:
    """The port's SystemConfig from `dataclasses.asdict` of the reference's
    (its sections nested dicts)."""
    return config.SystemConfig(
        camera=camera_config_from_dict(d["camera"]),
        orb=config.ORBConfig(**d["orb"]),
        nmi=nmi_config_from_dict(d["nmi"]),
        viewer=config.ViewerConfig(**{**d["viewer"], "viewpoint": tuple(d["viewer"]["viewpoint"])}),
        tracking=config.TrackingConfig(**d["tracking"]),
        vocabulary_path=d["vocabulary_path"],
        output_dir=d["output_dir"],
    )


def track_carry_from_numpy(fields: dict, device: str | torch.device = "cuda") -> TrackCarry:
    """The port's TrackCarry, on `device`, from a dict of the reference's
    TrackCarry fields as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
    carry._asdict().items()}`). The uint32 descriptor words keep their bits
    as int32."""
    missing = set(TrackCarry._fields) - set(fields)
    if missing:
        raise ValueError(f"carry fields missing: {sorted(missing)}")
    dtypes = {"Tcw": np.float32, "velocity": np.float32, "xy": np.float32, "octave": np.int32,
              "angle": np.float32, "pts": np.float32, "bound": bool}
    out = {}
    for k in TrackCarry._fields:
        a = np.asarray(fields[k])
        a = a.astype(np.uint32).view(np.int32) if k == "desc" else a.astype(dtypes[k])
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TrackCarry(**out)
