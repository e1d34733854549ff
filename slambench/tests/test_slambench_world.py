"""The generator: the same seed gives the same inputs, another seed others."""

import numpy as np
import torch

from slambench import world
from slambench import nmi_check
from slambench.drivers import reloc
from slambench.tests.conftest import small_config, small_traffic


def _inputs(seed, pool=6):
    cfg, traffic = small_config("zumav_mesh"), small_traffic()
    traffic["pool"] = pool
    mesh = world.terrain_mesh(cfg["prior"]["world_seed"], cfg["prior"])
    qs = reloc.make_queries(cfg, traffic, seed)
    lit = torch.from_numpy(world.lit_texture(mesh, cfg["scene"]["sun"], cfg["scene"]["ambient"]))
    gen = torch.Generator()
    gen.manual_seed(seed)
    frames = world.raycast_frames(np.stack([q.Tcw_true for q in qs]), cfg["camera"], cfg["prior"],
                                  lit, np.array([q.frame_index for q in qs], np.float64),
                                  cfg["scene"]["circuit"]["frames"], cfg["scene"]["gap"], gen)
    return mesh, qs, frames


def test_same_seed_same_inputs():
    a, b = _inputs(2**31 + 5), _inputs(2**31 + 5)
    assert np.array_equal(a[0].texture_gray, b[0].texture_gray)
    for qa, qb in zip(a[1], b[1]):
        assert np.array_equal(qa.Tcw_prior, qb.Tcw_prior) and qa.span == qb.span
    assert torch.equal(a[2], b[2])


def test_other_seed_other_inputs_same_spans():
    a, b = _inputs(2**31 + 5, pool=31), _inputs(2**31 + 6, pool=31)
    # the world is the configuration's, the queries the traffic mix's
    assert np.array_equal(a[0].texture_gray, b[0].texture_gray)
    key = lambda q: (q.frame_index, q.span, q.Tcw_prior.tobytes())  # noqa: E731
    assert sorted(map(key, a[1])) == sorted(map(key, b[1]))
    assert sorted(q.span for q in a[1]) == list(range(10, 41))
    # in another order, with other sensor noise
    assert [q.span for q in a[1]] != [q.span for q in b[1]]
    assert not torch.equal(a[2], b[2])


def test_prior_is_off_by_the_drift_share():
    cfg, traffic = small_config("zumav_mesh"), small_traffic()
    for q in reloc.make_queries(cfg, traffic, 99):
        assert 10 <= q.span <= 40
        gap_m, gap_rad = nmi_check.pose_gap(q.Tcw_true, q.Tcw_prior)
        assert gap_m <= 1.01 * traffic["prior_error"] * np.linalg.norm(q.dist) + 1e-6
        assert gap_m > 0


def test_frames_see_the_terrain():
    _, _, frames = _inputs(3)
    assert frames.dtype == torch.uint8
    assert frames.float().std() > 10  # textured, not blank
