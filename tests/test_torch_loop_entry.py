"""Place recognition and loop closing on the rendered circuit, small, on the
CPU: `entry.loop_entry` on the reduced loop scene (480x270, 60x60 terrain,
500 features; keyframes at frames 0, 8, 10, 12, 14), then
`entry.add_revisit_arc` with six frames of the circuit's second lap (the
poses of frames -13.8 .. 16.2) and the default drift.

  * `loop_entry`'s hooks: the vocabulary trains from the first keyframes
    (k=8, depth 4, seed 0), the database holds every mapped keyframe and
    leaves with a culled one, and the loop closer's global BA goes to the
    pipeline's thread;
  * `entry.relocalize_pnp` of frame 482 (the pose of frame 10.2) against
    the mapped keyframes, before the arc: within 0.1 m of the truth;
  * the arc: each keyframe's centre is the drifted true centre and its
    rotation R_cw R_D^T (within 1e-4), consecutive arc keyframes share
    points, and none observes a point of the map before it;
  * the session's own closer (covisibility consistency 0, as in
    tests/test_loop_closing.py) closes one loop, against a keyframe of the
    mapped frames; the global BA lands; the closing keyframe's camera-centre
    error falls below half of its error before;
  * the same closure in the JAX package, from the state just before it (the
    same map, vocabulary and database; the JAX package's draws): the same
    closing pair, equal observation tables after the correction, poses
    within 1e-4 and points within 1e-3 m (measured 5.5e-6 and 2.7e-5 m).

On the card (the `gpu` marker), the same comparison at full width from the
state of `chip_smoke.py`'s loop phase.
"""

import copy

import numpy as np
import pytest
from torch_port_fixtures import (LOOP_ARC, JaxDraws, cuda_device, jax_system_config,  # noqa: F401
                                 loop_scene, map_fields)

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch.entry import ARC_DRIFT, add_revisit_arc, drift_sim3, relocalize_pnp
from orbslam2_nmi_torch.slam import loop_closing as tlc
from orbslam2_nmi_torch.slam.checkpoint import _MAP_FIELDS
from orbslam2_nmi_tpu.slam import keyframe_database as jdb
from orbslam2_nmi_tpu.slam import loop_closing as jlc
from orbslam2_nmi_tpu.slam import map_store as jms
from orbslam2_nmi_tpu.slam import vocabulary as jv

TABLES = ("kf_mp_idx", "mp_obs_kf", "mp_obs_feat", "mp_obs_n", "mp_valid", "covis")
POSE_ATOL, PTS_ATOL = 1e-4, 1e-3
PNP_FRAME, PNP_ERR_M = 482, 0.1  # the pose of frame 10.2; chip_smoke.py's bar


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)


@pytest.fixture(scope="module")
def run():
    s = loop_scene()
    try:
        m, lc = s.map, s.system.loop_closer
        n_old = int(m.n_keyframes)
        img = s.world.render_frames([PNP_FRAME], 520, s.cfg.camera.width, s.cfg.camera.height,
                                    device="cpu")[0]
        tries = relocalize_pnp(s, PNP_FRAME, frame=img)
        arc = add_revisit_arc(s, LOOP_ARC)
        with m.lock:
            before = dict(fields=map_fields(m), db=copy.deepcopy(vars(lc.db)),
                          err=[float(np.linalg.norm(_center(m.kf_Tcw[k])
                                                    - _center(s.world.pose_at(i, 520))))
                               for i, k in arc])
        lc.covisibility_consistency_th = 0
        closed = []
        for i, k in arc:
            with m.lock:
                if lc.process_keyframe(k):
                    closed.append((i, k, lc.records[-1]["closed_with"]))
        s.flush()
        with m.lock:
            after = [float(np.linalg.norm(_center(m.kf_Tcw[k])
                                          - _center(s.world.pose_at(i, 520)))) for i, k in arc]
        yield dict(s=s, arc=arc, n_old=n_old, before=before, closed=closed, after=after,
                   tries=tries)
    finally:
        s.shutdown()


def test_loop_entry_wires_place_recognition(run):
    s, n_old = run["s"], run["n_old"]
    sysm = s.system
    vr = sysm.vocab_record
    assert vr is not None and vr["words"] > 0 and vr["thread"] in ("MainThread", "local-mapping")
    assert sysm.vocabulary.k == 8 and sysm.vocabulary.depth == 4
    assert sysm.loop_closer.gba_launcher == s.pipeline.launch_global_ba
    assert sysm.database.erase in s.map.on_keyframe_removed
    assert all(run["before"]["db"]["active"][:n_old])
    assert not s.pipeline.errors()


def test_revisit_arc_is_drifted_and_apart(run):
    s, arc, n_old = run["s"], run["arc"], run["n_old"]
    f = run["before"]["fields"]
    D = drift_sim3(**ARC_DRIFT)
    RD = D[:3, :3] / ARC_DRIFT["scale"]
    old_points = set(f["kf_mp_idx"][:n_old][f["kf_mp_idx"][:n_old] >= 0].tolist())
    for j, (i, k) in enumerate(arc):
        T_true = s.world.pose_at(i, 520).astype(np.float64)
        T = f["kf_Tcw"][k].astype(np.float64)
        np.testing.assert_allclose(_center(T), D[:3, :3] @ _center(T_true) + D[:3, 3],
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(T[:3, :3], T_true[:3, :3] @ RD.T, atol=POSE_ATOL)
        own = f["kf_mp_idx"][k][f["kf_mp_idx"][k] >= 0]
        assert len(own) > 0 and not old_points.intersection(own.tolist())
        assert not f["covis"][k, :n_old].any()
        if j:
            assert f["covis"][k, arc[j - 1][1]] > 0


def test_relocalize_pnp_against_the_map(run):
    """BoW candidates, matching and EPnP RANSAC for a frame of the second lap
    against the mapped keyframes: a pose within 0.1 m of the truth."""
    s, tries = run["s"], run["tries"]
    ok = [t for t in tries if t.get("ok")]
    assert ok, tries
    t = ok[0]
    assert t["matches"] >= 15 and t["n_inliers"] >= 10 and t["inputs"]["samples"].shape == (128, 4)
    err = np.linalg.norm(_center(t["Tcw"]) - _center(s.world.pose_at(PNP_FRAME, 520)))
    assert err < PNP_ERR_M, err


def test_session_closes_the_arc(run):
    closed, n_old = run["closed"], run["n_old"]
    assert len(closed) == 1
    i, k, cand = closed[0]
    assert 0 <= cand < n_old
    j = [kk for _, kk in run["arc"]].index(k)
    assert run["after"][j] < 0.5 * run["before"]["err"][j], (run["before"]["err"], run["after"])
    gba = run["s"].pipeline.gba_records
    assert gba and gba[-1]["applied"]


def test_arc_closure_matches_reference(run):
    s, arc = run["s"], run["arc"]
    before = run["before"]
    cfg = s.cfg
    tm = convert.map_store_from_fields(before["fields"], cfg)
    voc = s.system.vocabulary
    tdb_ = convert.database_from_fields(before["db"], voc)
    tc = tlc.LoopCloser(cfg, tm, tdb_, None, device="cpu")
    tc.draw_samples = JaxDraws(7)
    jcfg = jax_system_config(cfg)
    jm = jms.MapStore(jcfg)
    for f in _MAP_FIELDS:
        getattr(jm, f)[...] = before["fields"][f]
    jm.n_keyframes, jm.n_points = before["fields"]["n_keyframes"], before["fields"]["n_points"]
    jvoc = jv.Vocabulary(k=voc.k, depth=voc.depth, node_desc=voc.node_desc,
                         children=voc.children, leaf_id=voc.leaf_id,
                         word_weight=voc.word_weight)
    jdb_ = jdb.KeyFrameDatabase(jvoc, cfg.tracking.max_keyframes,
                                max_words=cfg.tracking.max_features)
    for key, value in copy.deepcopy(before["db"]).items():
        if key != "vocab":
            setattr(jdb_, key, value)
    jc = jlc.LoopCloser(jcfg, jm, jdb_, local_mapper=None)
    for c in (tc, jc):
        c.covisibility_consistency_th = 0
    out = [(tc.process_keyframe(k), jc.process_keyframe(k)) for _, k in arc]
    assert [a for a, _ in out] == [b for _, b in out] and sum(a for a, _ in out) == 1
    assert [e[:2] for e in tc.loop_edges] == [e[:2] for e in jc.loop_edges]
    assert tc.loop_edges[0][:2] == (run["closed"][0][2], run["closed"][0][1])
    for f in TABLES:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    np.testing.assert_allclose(tm.kf_Tcw, jm.kf_Tcw, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tm.mp_pos[tm.mp_valid], jm.mp_pos[jm.mp_valid], atol=PTS_ATOL,
                               rtol=0)


@pytest.mark.gpu
def test_full_scene_closure_matches_reference(cuda_device, record_property):  # noqa: F811
    """`chip_smoke.py`'s loop phase at full width on the card (960x540, frames
    0 and 8-68 mapped, the default arc, consistency 3), and its closure
    replayed from the state just before it by the port (CPU, the JAX
    package's draws) and by the JAX package: the same accept, matches, loop
    points and observation tables, and the same number of the closing
    keyframe's own points surviving loop fusion (recorded)."""
    from orbslam2_nmi_torch.entry import loop_entry

    s = loop_entry(device=cuda_device)
    snap = {}
    try:
        s.initialize()
        for i in s.track_ids:
            s.track_frame(i)
        s.flush()
        arc = add_revisit_arc(s)
        lc = s.system.loop_closer
        compute = lc._compute_sim3

        def recorded(k, cand):
            fields = map_fields(s.map)
            out = compute(k, cand)
            if out[0] and not snap:
                snap.update(k=k, cand=cand, fields=fields)
            return out

        lc._compute_sim3 = recorded
        for _, k in arc:
            with s.map.lock:
                lc.process_keyframe(k)
        s.flush()
    finally:
        s.shutdown()
    assert snap, "no loop closed"
    k, cand, fields = snap["k"], snap["cand"], snap["fields"]
    tm = convert.map_store_from_fields(fields, s.cfg)
    tc = tlc.LoopCloser(s.cfg, tm, None, None, device="cpu")
    tc.draw_samples = JaxDraws(7)
    jm = jms.MapStore(jax_system_config(s.cfg))
    for f in _MAP_FIELDS:
        getattr(jm, f)[...] = fields[f]
    jm.n_keyframes, jm.n_points = fields["n_keyframes"], fields["n_points"]
    jc = jlc.LoopCloser(jax_system_config(s.cfg), jm, None, local_mapper=None)
    own = (fields["mp_first_kf"] == k) & fields["mp_valid"]
    res = {}
    for name, c, m in (("port", tc, tm), ("jax", jc, jm)):
        ok, S, mc, lm = c._compute_sim3(k, cand)
        assert ok, name
        c._correct_loop(k, cand, S, mc, lm)
        res[name] = dict(matched=mc, loop_mps=lm, surviving=int((own & m.mp_valid).sum()))
    for key in ("matched", "loop_mps"):
        np.testing.assert_array_equal(res["port"][key], res["jax"][key], err_msg=key)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    record_property("closing_pair", [int(k), int(cand)])
    record_property("own_points", int(own.sum()))
    record_property("surviving_port", res["port"]["surviving"])
    record_property("surviving_jax", res["jax"]["surviving"])
    assert res["port"]["surviving"] == res["jax"]["surviving"]
