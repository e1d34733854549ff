"""The port's sharded paths (`orbslam2_nmi_torch/parallel/`) against the JAX
package, on worlds of 2 and 4 gloo ranks on the CPU (spawned processes, one
world of each size for the whole file: `torch_port_fixtures.run_ranks`).

The problems are `tests/test_sharding.py`'s, made from the same seeds:
  * the sharded pose graph (V 10 with a loop edge; E = 10 is not a
    multiple of 4, so the edge padding runs there) against the JAX package's
    `sharded_optimize_pose_graph` on `make_mesh(4)` of the conftest's 8 CPU
    devices: within 1e-4;
  * the sharded BA on `tests/test_ba.make_ba_problem(seed=4)`: the cameras
    within 5e-3 of the JAX package's result, reprojection RMSE at most
    max(2 x its, 0.05) (test_sharding.py:22-32's bars); seed 5's fixed
    cameras equal to the bit. The JAX side is its UNSHARDED
    `local_ba.bundle_adjust`: its sharded call compiles for ~56 s here (the
    JAX package marks that test slow), and test_sharding.py holds the two
    JAX paths to these bars;
  * the splat NMI search (120x160, 27 x 27 on 30,000 points) and the mesh
    NMI search (48x128, 8 x 4 on the 30 x 30 height field, the frame the
    port's render at I, the same array on both sides): the JAX side is
    its unsharded path (`render_translation_grid` or `render_mesh_grid` in
    interpret mode, `warp_rotation_grid`, `nmi_scores(use_pallas=False)`),
    for the same reason (test_sharding.py holds the two JAX paths within
    1e-4); the splat within 1e-4, its argmax the aligned centre; the mesh
    within the mesh grid's bar of 8.1e-4 (B3's renders differ from the
    reference's where a UV quantum flips, test_torch_localizer), its argmax
    the reference's, and to the bit against the port's unsharded path.
Every rank returns the same result, and the pad rows of the NMI grids
(27 renders over 2 or 4 ranks) never reach the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_fixtures import run_ranks, sharding_mesh_problem, sharding_rank

from orbslam2_nmi_torch.parallel import sharded_ba as tsba
from orbslam2_nmi_torch.parallel import sharded_nmi as tsn
from orbslam2_nmi_tpu.geometry import se3 as jse3
from orbslam2_nmi_tpu.io.model_loader import MeshModel
from orbslam2_nmi_tpu.ops import histogram_nmi, homography, raster, render
from orbslam2_nmi_tpu.parallel import mesh as jmesh
from orbslam2_nmi_tpu.parallel import sharded_ba as jsba
from orbslam2_nmi_tpu.parallel import sharded_nmi as jsn
from orbslam2_nmi_tpu.parallel import sharded_pose_graph as jspg
from orbslam2_nmi_tpu.solvers import local_ba, pose_graph

from test_ba import K, make_ba_problem, reproj_rmse

PG_ATOL = 1e-4
BA_CAM_ATOL = 5e-3
NMI_ATOL = 1e-4
MESH_NMI_ATOL = 8.1e-4  # test_torch_localizer's MESH_GRID_ATOL: B3's UV flips


def _pose_graph_problem():
    """test_sharding.py's V 10 chain with a biased odometry and a loop edge."""
    V = 10
    gt = [np.asarray(jse3.se3_exp(jnp.asarray([0.5 * i, 0, 0, 0, 0, 0], jnp.float32)))
          for i in range(V)]
    est = [gt[0]]
    bias = np.asarray(jse3.se3_exp(jnp.asarray([0.02, 0.01, 0.0, 0.0, 0.004, 0.0], jnp.float32)))
    for i in range(1, V):
        est.append(bias @ (gt[i] @ np.linalg.inv(gt[i - 1])) @ est[i - 1])
    est = np.stack(est)
    meas = [est[i + 1] @ np.linalg.inv(est[i]) for i in range(V - 1)]
    meas.append(gt[V - 1] @ np.linalg.inv(gt[0]))
    return dict(Scw=est.astype(np.float32), fixed=np.arange(V) == 0, valid=np.ones(V, bool),
                edge_i=np.asarray(list(range(V - 1)) + [0], np.int32),
                edge_j=np.asarray(list(range(1, V)) + [V - 1], np.int32),
                edge_Sji=np.stack(meas).astype(np.float32), edge_valid=np.ones(V, bool), iters=10)


def _splat_problem():
    rng = np.random.default_rng(0)
    n = 30000
    pts = np.stack([rng.uniform(-15, 15, n), rng.uniform(-10, 10, n), rng.uniform(8, 20, n)],
                   -1).astype(np.float32)
    gray = ((np.floor(pts[:, 0]) * 37 + np.floor(pts[:, 1]) * 91) % 256).astype(np.float32)
    Kc = np.array([[120.0, 0, 80], [0, 120.0, 60], [0, 0, 1]], np.float32)
    model = render.RenderModel(points=jnp.asarray(pts), gray=jnp.asarray(gray))
    frame = np.asarray(render.render_pointcloud(model, jnp.eye(4), jnp.asarray(Kc), 120, 160,
                                                1.0, 30.0, 3))
    return dict(points=pts, gray=gray, frame=frame, Tcw=np.eye(4, dtype=np.float32),
                offsets=np.asarray(render.translation_grid_offsets((3, 3, 3), (0.3, 0.3, 0.3))),
                angles=np.asarray(homography.rotation_grid_angles((3, 3, 3), (0.03, 0.03, 0.03))),
                K=Kc, hw=(120, 160), near_far=(1.0, 30.0))


def _ba_fields(seed):
    prob, _, _ = make_ba_problem(seed=seed)
    return prob, {k: np.asarray(v) for k, v in prob._asdict().items()}


@pytest.fixture(scope="module")
def problems():
    return dict(pose_graph=_pose_graph_problem(), ba4=dict(fields=_ba_fields(4)[1]),
                ba5=dict(fields=_ba_fields(5)[1]), nmi_splat=_splat_problem(),
                nmi_mesh=sharding_mesh_problem())


@pytest.fixture(scope="module")
def worlds(problems):
    """Every problem through the port on a world of 2 and one of 4 ranks."""
    return {d: run_ranks(sharding_rank, d, problems) for d in (2, 4)}


@pytest.fixture(scope="module")
def refs(problems):
    """The JAX package's results, once for both worlds (see the module
    docstring for which path each is)."""
    p = problems["pose_graph"]
    prob = pose_graph.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in p.items()
                                          if k != "iters"})
    out = dict(pose_graph=np.asarray(jspg.sharded_optimize_pose_graph(jmesh.make_mesh(4), prob,
                                                                      iters=10)))
    prob4 = _ba_fields(4)[0]
    out["ba4"] = (prob4, local_ba.bundle_adjust(prob4))
    p = problems["nmi_splat"]
    model = render.RenderModel(points=jnp.asarray(p["points"]), gray=jnp.asarray(p["gray"]))
    synth = render.render_translation_grid(model, jnp.eye(4), jnp.asarray(p["K"]),
                                           jnp.asarray(p["offsets"]), 120, 160, 1.0, 30.0, 3)
    warped = homography.warp_rotation_grid(jnp.asarray(p["frame"]), jnp.asarray(p["K"]),
                                           jnp.asarray(p["angles"]))
    out["nmi_splat"] = np.asarray(histogram_nmi.nmi_scores(synth, warped, use_pallas=False))
    p = problems["nmi_mesh"]
    binned = raster.bin_mesh(MeshModel(*p["mesh"]), np.eye(4, dtype=np.float32), p["K"], 48, 128,
                             1.0, 30.0, max_offset=(0.3, 0.3, 0.3))
    synth = raster.render_mesh_grid(binned, np.eye(4, dtype=np.float32), p["K"],
                                    jnp.asarray(p["offsets"]), 1.0, 30.0, interpret=True)
    warped = homography.warp_rotation_grid(jnp.asarray(p["frame"]), jnp.asarray(p["K"]),
                                           jnp.asarray(p["angles"]))
    out["nmi_mesh"] = np.asarray(histogram_nmi.nmi_scores(synth, warped, use_pallas=False))
    return out


def _same_on_every_rank(outs, name):
    """Rank 0's result for `name`, after checking every rank's is the same."""
    flat = [o[name] if isinstance(o[name], tuple) else (o[name],) for o in outs]
    for other in flat[1:]:
        for a, b in zip(flat[0], other):
            np.testing.assert_array_equal(a, b)
    return outs[0][name]


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_pose_graph_matches_reference(worlds, refs, D):
    got = _same_on_every_rank(worlds[D], "pose_graph")
    np.testing.assert_allclose(got, refs["pose_graph"], atol=PG_ATOL, rtol=0)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ba_matches_reference(worlds, refs, D):
    prob, single = refs["ba4"]
    cam, pts, inlier, chi2 = _same_on_every_rank(worlds[D], "ba4")
    r1 = reproj_rmse(K, single.cam_Tcw, single.pts_w, prob)
    r2 = reproj_rmse(K, jnp.asarray(cam), jnp.asarray(pts), prob)
    assert r2 < max(2 * r1, 0.05), (r1, r2)
    np.testing.assert_allclose(cam, np.asarray(single.cam_Tcw), atol=BA_CAM_ATOL, rtol=0)
    assert inlier.shape == chi2.shape == (prob.obs_cam.shape[0],)
    np.testing.assert_array_equal(inlier, np.asarray(single.obs_inlier))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ba_fixed_cameras_pinned(worlds, problems, D):
    cam = _same_on_every_rank(worlds[D], "ba5")[0]
    np.testing.assert_array_equal(cam[:2], problems["ba5"]["fields"]["cam_Tcw"][:2])


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_nmi_matches_reference(worlds, refs, D):
    got = _same_on_every_rank(worlds[D], "nmi_splat")
    assert got.shape == (27, 27) and np.isfinite(got).all()
    np.testing.assert_allclose(got, refs["nmi_splat"], atol=NMI_ATOL, rtol=0)
    assert int(np.argmax(got)) == 13 * 27 + 13


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_nmi_mesh_matches_reference(worlds, refs, problems, D):
    """Against the JAX package within the mesh grid's bar (its renders' UV
    quantum flips, test_torch_localizer; measured 1.6e-4), with its argmax;
    against the port's own unsharded render and score to the bit."""
    import torch

    from orbslam2_nmi_torch.io.model_loader import MeshModel as TMeshModel
    from orbslam2_nmi_torch.ops import histogram_nmi as thn
    from orbslam2_nmi_torch.ops import homography as thom
    from orbslam2_nmi_torch.ops import raster as traster

    got = _same_on_every_rank(worlds[D], "nmi_mesh")
    assert got.shape == (8, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, refs["nmi_mesh"], atol=MESH_NMI_ATOL, rtol=0)
    assert int(np.argmax(got)) == int(np.argmax(refs["nmi_mesh"]))
    p = problems["nmi_mesh"]
    b = traster.bin_mesh(TMeshModel(*p["mesh"]), p["Tcw"], p["K"], 48, 128, 1.0, 30.0,
                         max_offset=p["max_offset"], device="cpu")
    synth = traster.render_mesh_grid(b, torch.eye(4), p["K"], torch.from_numpy(p["offsets"]),
                                     1.0, 30.0)
    warped = thom.warp_rotation_grid(torch.from_numpy(p["frame"]), p["K"], p["angles"])
    np.testing.assert_array_equal(got, thn.nmi_scores(synth, warped).numpy())


def test_pad_to_multiple():
    """The port's padding equals the JAX package's (test_sharding.py's case
    and a multiple that needs none)."""
    import torch

    x = np.ones((5, 3), np.float32)
    for m, fill in ((8, 7.0), (5, 0.0), (2, 1e6)):
        got = tsn.pad_to_multiple(torch.from_numpy(x), m, axis=0, fill=fill).numpy()
        np.testing.assert_array_equal(got, np.asarray(jsn.pad_to_multiple(jnp.asarray(x), m,
                                                                          axis=0, fill=fill)))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_host_grouping_matches_reference(n_dev):
    """`_balance_points` and `_group_obs_by_point_shard` (numpy copies)
    equal the JAX package's, on seed 4's observations."""
    prob, fields = _ba_fields(4)
    obs_pt, P = fields["obs_pt"], fields["pts_w"].shape[0]
    got = tsba._balance_points(obs_pt, P, n_dev)
    want = jsba._balance_points(obs_pt, P, n_dev)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsba._group_obs_by_point_shard(obs_pt, got[0], n_dev),
                    jsba._group_obs_by_point_shard(obs_pt, want[0], n_dev)):
        np.testing.assert_array_equal(a, b)
