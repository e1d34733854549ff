"""Carry the JAX package's state into the port.

The two packages share no objects; state passes between them as numpy arrays
and plain dicts: the binned mesh (the JAX `BinnedMesh` built with
`device_arrays=False`, whose fields are numpy arrays and Python scalars), the
point-splat render model, the configurations (the `dataclasses.asdict` of
the JAX dataclasses), the tracking step's carry, the map (the arrays of the
map store, which are also a checkpoint's fields, `slam/checkpoint.py`) and
a bundle-adjustment problem, the vocabulary and the keyframe database, so
that both packages render, score, search, track, map and close loops with
the same state in the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam2_nmi_torch import config
from orbslam2_nmi_torch.io.model_loader import PointCloudModel
from orbslam2_nmi_torch.ops import raster, render
from orbslam2_nmi_torch.slam.checkpoint import _MAP_FIELDS
from orbslam2_nmi_torch.slam.fused_track import TrackCarry
from orbslam2_nmi_torch.slam.keyframe_database import KeyFrameDatabase
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.slam.vocabulary import Vocabulary
from orbslam2_nmi_torch.solvers.local_ba import BAProblem

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


def map_store_from_fields(fields: dict, cfg: config.SystemConfig) -> MapStore:
    """A port MapStore sized by `cfg` holding the 27 map arrays of `fields`
    (`checkpoint._MAP_FIELDS`) and its `n_keyframes` and `n_points`: e.g.
    `np.load` of a checkpoint, or `{f: getattr(m, f) for f in _MAP_FIELDS}`
    of a JAX MapStore plus its two counts. A capacity that differs from
    `cfg`'s raises, as `checkpoint.load_map` does. The delayed-reuse queue of
    freed point slots is not part of the fields (nor of a checkpoint): it
    starts empty."""
    missing = set(_MAP_FIELDS + ["n_keyframes", "n_points"]) - set(fields)
    if missing:
        raise ValueError(f"map fields missing: {sorted(missing)}")
    m = MapStore(cfg)
    for f in _MAP_FIELDS:
        arr = np.asarray(fields[f])
        target = getattr(m, f)
        if target.shape != arr.shape:
            raise ValueError(f"map field {f} shape {arr.shape} does not match the configured "
                             f"capacity {target.shape}")
        target[...] = arr
    m.n_keyframes = int(fields["n_keyframes"])
    m.n_points = int(fields["n_points"])
    return m


def ba_problem_from_numpy(fields: dict, device: str | torch.device = "cuda") -> BAProblem:
    """The port's BAProblem, on `device`, from a dict of the reference's
    BAProblem fields as numpy arrays (e.g. `{k: np.asarray(v) for k, v in
    prob._asdict().items()}`)."""
    missing = set(BAProblem._fields) - set(fields)
    if missing:
        raise ValueError(f"BA problem fields missing: {sorted(missing)}")
    dtypes = {"K": np.float32, "cam_Tcw": np.float32, "cam_fixed": bool, "cam_valid": bool,
              "pts_w": np.float32, "pts_valid": bool, "obs_cam": np.int32, "obs_pt": np.int32,
              "obs_uv": np.float32, "obs_inv_sigma2": np.float32, "obs_valid": bool}
    return BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(np.asarray(fields[k], dtypes[k])))
                        .to(device) for k in BAProblem._fields})


def vocabulary_from_numpy(fields: dict, device: str | torch.device = "cuda") -> Vocabulary:
    """The port's Vocabulary, its descent on `device`, from the reference's
    fields (`node_desc`, `children`, `leaf_id`, `word_weight`, `k`, `depth`):
    e.g. `np.load` of a `.npz` saved by either package, or `vars()` of the
    reference's Vocabulary."""
    missing = {"node_desc", "children", "leaf_id", "word_weight", "k", "depth"} - set(fields)
    if missing:
        raise ValueError(f"vocabulary fields missing: {sorted(missing)}")
    return Vocabulary(k=int(fields["k"]), depth=int(fields["depth"]),
                      node_desc=np.asarray(fields["node_desc"], np.uint32),
                      children=np.asarray(fields["children"], np.int32),
                      leaf_id=np.asarray(fields["leaf_id"], np.int32),
                      word_weight=np.asarray(fields["word_weight"], np.float32)).to(device)


def database_from_fields(fields: dict, vocab: Vocabulary) -> KeyFrameDatabase:
    """The port's KeyFrameDatabase over `vocab` holding the reference's
    entries (`kf_words`, `kf_weights`, `kf_nwords`, `active`) and inverted
    file (`inverted`, word -> keyframe list, copied in its order): e.g.
    `vars()` of the reference's KeyFrameDatabase."""
    missing = {"kf_words", "kf_weights", "kf_nwords", "active", "inverted"} - set(fields)
    if missing:
        raise ValueError(f"database fields missing: {sorted(missing)}")
    words = np.asarray(fields["kf_words"], np.int64)
    db = KeyFrameDatabase(vocab, words.shape[0], max_words=words.shape[1])
    db.kf_words[...] = words
    db.kf_weights[...] = np.asarray(fields["kf_weights"], np.float32)
    db.kf_nwords[...] = np.asarray(fields["kf_nwords"], np.int32)
    db.active[...] = np.asarray(fields["active"], bool)
    db.inverted = {int(w): [int(k) for k in kfs] for w, kfs in fields["inverted"].items()}
    return db
