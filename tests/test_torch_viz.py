"""The port's headless visualization (`orbslam2_nmi_torch/viz/replay.py`)
against the JAX package's `viz/replay.py`, on the same inputs.

Bars: exact. `draw_frame`, `plot_map_topdown` (a map store with points,
keyframes, NMI-anchored keyframes and a trajectory) and
`save_nmi_debug_overlay` write byte-equal images, as PNG files where PIL
is installed and as `.npy` arrays where it is not. Where the JAX
`plot_map_topdown` raises on an empty map, the port draws nothing.
"""

import sys

import numpy as np
import pytest

from orbslam2_nmi_torch.config import SystemConfig, TrackingConfig
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.viz import replay as tviz
from orbslam2_nmi_tpu.viz import replay as jviz


def _pose(yaw, t):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _map():
    rng = np.random.default_rng(0)
    m = MapStore(SystemConfig(tracking=TrackingConfig(max_keyframes=16, max_map_points=512)))
    m.mp_pos[:300] = rng.normal(0, 5, (300, 3)).astype(np.float32)
    m.mp_valid[:300] = True
    m.mp_valid[::7] = False
    m.n_points, m.n_keyframes = 300, 6
    for k in range(6):
        m.kf_Tcw[k] = _pose(0.3 * k, (k, 0.5 * k, 2.0))
        m.kf_valid[k] = k != 4
        m.kf_nmi_reloc[k] = k % 2 == 0
    traj = [(i, i / 30.0, _pose(0.05 * i, (0.2 * i, 0.1, 2.0)), 0, None) for i in range(40)]
    return m, traj


def _inputs():
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    xy = np.concatenate([rng.uniform(-5, 70, (60, 2)), [[0, 0], [63, 47]]]).astype(np.float32)
    tracked = rng.random(len(xy)) < 0.6
    return gray, xy, tracked


def _draw_all(viz, out, m, traj):
    gray, xy, tracked = _inputs()
    viz.draw_frame(gray, xy, tracked, str(out / "frame.png"))
    viz.draw_frame(gray, xy, tracked, str(out / "frame_r4.png"), radius=4)
    viz.plot_map_topdown(m, str(out / "map.png"), trajectory=traj, size=300)
    viz.plot_map_topdown(m, str(out / "map_xy.png"), size=200, axes=(0, 1))
    cam = np.random.default_rng(2).uniform(0, 255, (48, 64)).astype(np.float32)
    synth = np.random.default_rng(3).uniform(0, 255, (40, 70)).astype(np.float32)
    viz.save_nmi_debug_overlay(cam, synth, str(out / "overlay.png"))


def _read(path):
    if path.suffix == ".npy":
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


@pytest.mark.parametrize("pil", [True, False])
def test_images_equal_reference(pil, tmp_path, monkeypatch):
    if pil:
        pytest.importorskip("PIL")
    else:
        monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises
    m, traj = _map()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    _draw_all(tviz, tmp_path / "t", m, traj)
    _draw_all(jviz, tmp_path / "j", m, traj)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 5 and all(n.endswith(".npy") != pil for n in names)
    for n in names:
        a, b = _read(tmp_path / "t" / n), _read(tmp_path / "j" / n)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    overlay = _read(tmp_path / "t" / names[-1])
    assert overlay.shape == (40, 64, 3) and not overlay[..., 2].any()


def test_empty_map_draws_nothing(tmp_path):
    m = MapStore(SystemConfig(tracking=TrackingConfig(max_keyframes=4, max_map_points=16)))
    tviz.plot_map_topdown(m, str(tmp_path / "map.png"))
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError):  # the JAX function's behaviour there
        jviz.plot_map_topdown(m, str(tmp_path / "map.png"))
