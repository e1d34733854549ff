"""The port's tracing (`utils/profiling.py`): the phase ranges, the records'
counters and the set-up counters, on the CPU.

  * each range opens under its parent in a CPU profile (the relocalization's
    sweeps and readbacks, the binning's three phases, the point splat's
    three phases, the front-end's phases, the mapping worker's keyframes),
    and none opens while no profiler runs;
  * a traced point-model relocalization renders what an untraced one does,
    bit for bit;
  * at 240x135 the binning's three phases cover at least 95 % of its range's
    host time;
  * a small `PipelinedFrontend` run (the end-to-end scene: 320x240, 25
    frames, asynchronous mapping, no NMI; a busy NMI worker stood in once)
    fills each frame's backpressure wait, keyframe and step times, and its
    times on the profiler's clock lie within 5 ms of the frame's ranges;
    the mapping worker's records carry their queue wait;
  * the set-up counters keep the first reading of a process; the point
    model's upload is one of them on the card only;
  * the records keep the newest frames and keyframes only.
"""

import collections
import tempfile
import time
import types

import numpy as np
import pytest
import torch
from torch_port_fixtures import (MESH_CAMERA, cuda_device, e2e_config, e2e_frames,  # noqa: F401
                                 height_field_mesh, make_world, mesh_frame)

from orbslam2_nmi_torch.config import CameraConfig, NMIConfig, NMIGridConfig
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld
from orbslam2_nmi_torch.ops import raster, render
from orbslam2_nmi_torch.slam import frontend_pipelined as fp
from orbslam2_nmi_torch.slam import local_mapping
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.slam.tracking import Tracker
from orbslam2_nmi_torch.slam.vocabulary import Vocabulary
from orbslam2_nmi_torch.tools import device_budget as tdb
from orbslam2_nmi_torch.utils import profiling

N_FRAMES = 25
TS = np.arange(N_FRAMES) / 10.0
BACKPRESSURE_AT = 12  # the chunk boundary at which a busy NMI worker is waited out
NMI_FLUSH_S = 0.03  # the stand-in worker's sweep
CLOCK_TOL_NS = 5_000_000  # a record's profiler-clock time against its frame's range


def small_relocalization():
    """(localizer, frame, prior): the height field's render at I and a prior
    0.3 m off, on a 3 x 1 grid at 256x48, two iterations."""
    mesh = height_field_mesh()
    cfg = NMIConfig(grid=NMIGridConfig(synth_num=(3, 1, 1), warp_num=(1, 1, 1),
                                       synth_step=(0.4, 0.4, 0.4), warp_step=(0.03,) * 3),
                    render_near=1.0, render_far=50.0, threshold=0.05, max_iteration_count=2)
    loc = NMILocalizer(cfg, CameraConfig(**MESH_CAMERA), None, mesh=MeshModel(*mesh),
                       device="cpu")
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.3
    return loc, mesh_frame(mesh), T


CLOUD_CAMERA = dict(fx=60.0, fy=60.0, cx=40.0, cy=30.0, width=80, height=60)
SPLAT_PHASES = ("render.splat.project", "render.splat.scatter", "render.splat.resolve")


def small_cloud_relocalization(device="cpu"):
    """(localizer, frame, prior): the point world's splat at I and a prior
    0.3 m off, on a 3 x 1 grid at 80x60, two iterations."""
    pts, gray = make_world(20000, seed=7)
    model = render.RenderModel(torch.from_numpy(pts), torch.from_numpy(gray))
    cfg = NMIConfig(grid=NMIGridConfig(synth_num=(3, 1, 1), warp_num=(1, 1, 1),
                                       synth_step=(0.4, 0.4, 0.4), warp_step=(0.03,) * 3),
                    render_near=1.0, render_far=30.0, threshold=0.05, max_iteration_count=2)
    cam = CameraConfig(**CLOUD_CAMERA)
    loc = NMILocalizer(cfg, cam, model, device=device)
    frame = render.render_pointcloud(loc.model, torch.eye(4), cam.K, cam.height, cam.width,
                                     1.0, 30.0, 3)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.3
    return loc, frame, T


def ranges(prof, names) -> dict:
    """{name: [(thread, start ns, end ns)]} of the profile's host ranges."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in names:
            out[e.name()].append((e.start_thread_id(), e.start_ns(), e.end_ns()))
    return out


def inside(child, parents) -> bool:
    tid, s, t = child
    return any(p_tid == tid and ps <= s and t <= pt for p_tid, ps, pt in parents)


def assert_nested(found: dict, parent_of: dict):
    for child, parents in parent_of.items():
        assert found[child], child
        outer = [r for p in parents for r in found[p]]
        for r in found[child]:
            assert inside(r, outer), (child, r)


class BusyWorker:
    """Stands in for the async NMI worker: busy, its sweep `NMI_FLUSH_S`."""

    def __init__(self):
        self.flushes = 0

    def busy(self):
        return True

    def flush(self, timeout=None):
        time.sleep(NMI_FLUSH_S)
        self.flushes += 1
        return True


@pytest.fixture(scope="module")
def frontend_run():
    """The end-to-end scene through the pipelined front-end with asynchronous
    mapping, profiled on every thread, in two chunks; before the second the
    tracker owes the NMI worker two skipped keyframes and the worker is
    busy, so the front-end waits it out once."""
    _, frames, poses = e2e_frames()
    sys_ = SLAMSystem(e2e_config(), use_nmi=False, output_dir=tempfile.mkdtemp(),
                      device="cpu", async_mapping=True)
    sys_.set_init_poses(poses[0], poses[4])
    fe = fp.PipelinedFrontend(sys_, n_cand=1024)
    worker = BusyWorker()
    try:
        with tdb.traced("cpu") as prof:
            fe.run(frames[:BACKPRESSURE_AT], TS[:BACKPRESSURE_AT], start_id=0)
            sys_.nmi_worker = worker
            sys_.tracker.nmi_due_skips = 2
            fe.run(frames[BACKPRESSURE_AT:], TS[BACKPRESSURE_AT:], start_id=BACKPRESSURE_AT)
            sys_.nmi_worker = None
            sys_.pipeline.flush(120)
        assert not sys_.pipeline.errors()
        yield types.SimpleNamespace(fe=fe, sys=sys_, prof=prof, worker=worker,
                                    mapping=list(sys_.local_mapper.records))
    finally:
        sys_.nmi_worker = None
        sys_.shutdown()


def test_frontend_ranges_nest_under_their_parents(frontend_run):
    found = ranges(frontend_run.prof, profiling.NAMES)
    assert_nested(found, {
        "frontend.map_lock": ("frontend.dispatch", "frontend.process"),
        "frontend.candidates": ("frontend.dispatch",),
        "fused_step": ("frontend.dispatch",),
        "frontend.readback_wait": ("frontend.process",),
        "frontend.keyframe": ("frontend.process",),
    })
    tracking = {tid for tid, _, _ in found["frontend.dispatch"]}
    assert len(tracking) == 1
    for name in ("frontend.process", "frontend.classic", "frontend.nmi_backpressure"):
        assert found[name] and {tid for tid, _, _ in found[name]} == tracking, name
    assert len(found["frontend.nmi_backpressure"]) == frontend_run.worker.flushes == 1
    # the mapping worker maps each keyframe inside its range, on its own thread
    # (a keyframe a reset wiped leaves its range and no record)
    mapped = found["mapping.keyframe"]
    assert len(mapped) >= len(frontend_run.mapping) >= 1
    assert not {tid for tid, _, _ in mapped} & tracking


def test_frame_records_carry_the_new_counters(frontend_run):
    fe = frontend_run.fe
    done = [r for r in fe.records.values() if r.get("outcome") != "fail"]
    assert len(done) == len(fe.completion_walls) == N_FRAMES
    waits = [r["nmi_wait_ms"] for r in done]
    assert min(waits) >= 0.0
    # the one wait is charged to one frame, the one tracked next
    assert sum(w > 0 for w in waits) == 1 and max(waits) >= 1e3 * NMI_FLUSH_S
    fused = [r for r in done if r["path"] == "fused"]
    assert len(fused) >= N_FRAMES // 2
    for r in fused:
        # on the CPU the step runs eagerly: no copies in or out
        assert r["step_in_ms"] == 0.0 and r["step_out_ms"] == 0.0
        assert 0.0 < r["launch_ms"] <= r["step_host_ms"] <= r["dispatch_ms"]
        assert ("kf_ms" in r) == ("kf" in r) == r["keyframe"]
    made = [r for r in fused if r["keyframe"]]
    assert made and all(r["kf_ms"] > 0.0 and r["kf"] >= 2 for r in made)


def test_mapping_records_carry_their_queue_wait(frontend_run):
    mapping = frontend_run.mapping
    assert mapping and all(r["queued_ms"] >= 0.0 for r in mapping)
    # a frame's record joins its keyframe's mapping record on the keyframe id
    made = {r["kf"] for r in frontend_run.fe.records.values() if "kf" in r}
    assert {r["kf"] for r in mapping} <= made


def test_frame_times_lie_on_the_profile(frontend_run):
    """A frame's start and completion on the profiler's clock fall inside its
    own ranges, within 5 ms: a fused frame's start in a dispatch range and
    its completion in a processing range, later frames in later ranges; a
    classic frame's both in its classic range (one a classic frame)."""
    found = ranges(frontend_run.prof, {"frontend.dispatch", "frontend.process",
                                       "frontend.classic"})
    spans = {k: sorted((s, e) for _, s, e in v) for k, v in found.items()}

    def within(t, span):
        return span[0] - CLOCK_TOL_NS <= t <= span[1] + CLOCK_TOL_NS

    def index(t, name):
        """The range of `name` nearest t (0 inside it), no more than 5 ms off."""
        off = [max(s - t, t - e, 0) for s, e in spans[name]]
        i = int(np.argmin(off))
        assert off[i] <= CLOCK_TOL_NS, (name, t, off[i])
        return i

    records = [frontend_run.fe.records[fid] for fid in sorted(frontend_run.fe.records)]
    assert all(r["t_dispatch_ns"] < r["t_done_ns"] for r in records)
    classic = [r for r in records if r["path"] == "classic"]
    assert len(classic) == len(spans["frontend.classic"])
    for r, span in zip(classic, spans["frontend.classic"]):
        assert within(r["t_dispatch_ns"], span) and within(r["t_done_ns"], span), r
    fused = [r for r in records if r["path"] == "fused"]
    for name, key in (("frontend.dispatch", "t_dispatch_ns"), ("frontend.process", "t_done_ns")):
        idx = [index(r[key], name) for r in fused]
        assert idx == sorted(set(idx)), name  # one range a frame, in frame order


def test_relocalization_ranges_nest_under_their_parents():
    loc, frame, T = small_relocalization()
    with tdb.traced("cpu") as prof:
        out = loc.relocalize_strategy(frame, T)
    assert out.iterations == 2
    found = ranges(prof, profiling.NAMES)
    assert_nested(found, {
        "nmi.sweep": ("nmi.relocalize",),
        "render.prepare_sweep": ("nmi.sweep",),
        "nmi.readback": ("nmi.sweep",),
        "render.bin_mesh": ("render.prepare_sweep",),
        "render.bin_mesh.build": ("render.bin_mesh",),
        "render.bin_mesh.slab": ("render.bin_mesh",),
        "render.bin_mesh.upload": ("render.bin_mesh",),
    })
    n = len(found["nmi.sweep"])
    assert len(found["nmi.relocalize"]) == 1 and n >= 1
    assert all(len(found[k]) == n for k in ("nmi.readback", "render.bin_mesh.build",
                                            "render.bin_mesh.slab", "render.bin_mesh.upload"))


def _kept_renders(loc) -> list:
    """The renders of every sweep `loc` makes from now on, kept on the host."""
    kept, render_sweep = [], loc.render_sweep

    def keep(sweep):
        out = render_sweep(sweep)
        kept.append(out.cpu().clone())
        return out

    loc.render_sweep = keep
    return kept


def test_splat_ranges_nest_under_the_grid_render():
    """A point-model relocalization opens the splat's three phases once a
    sweep, inside its `render_translation_grid`, and renders what the same
    relocalization renders untraced, bit for bit."""
    loc, frame, T = small_cloud_relocalization()
    plain = _kept_renders(loc)
    want = loc.relocalize_strategy(frame, T)
    loc, frame, T = small_cloud_relocalization()
    traced = _kept_renders(loc)
    with tdb.traced("cpu") as prof:
        got = loc.relocalize_strategy(frame, T)
    assert got.iterations == want.iterations == 2
    np.testing.assert_array_equal(got.Tcw, want.Tcw)
    assert len(traced) == len(plain) >= 2
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))
    found = ranges(prof, profiling.NAMES)
    assert_nested(found, {"render_translation_grid": ("nmi.sweep",),
                          **{k: ("render_translation_grid",) for k in SPLAT_PHASES}})
    n = len(found["nmi.sweep"])
    assert n == len(plain) and len(found["render_translation_grid"]) == n
    assert all(len(found[k]) == n for k in SPLAT_PHASES)


def test_bin_mesh_phases_cover_its_host_time():
    """The 71,442-face terrain binned at 240x135: the three phases hold at
    least 95 % of the `render.bin_mesh` range's host time."""
    world = SyntheticMeshWorld.generate()
    K = world.camera_K(240, 135)
    T = world.pose_at(0, 520)
    with tdb.traced("cpu") as prof:
        for _ in range(3):
            raster.bin_mesh(world.mesh, T, K, 135, 240, 5.0, 30.0,
                            max_offset=(0.2, 0.2, 0.5), device="cpu")
    found = ranges(prof, profiling.NAMES)
    total = sum(t - s for _, s, t in found["render.bin_mesh"])
    phases = sum(t - s for k in ("build", "slab", "upload")
                 for _, s, t in found[f"render.bin_mesh.{k}"])
    assert len(found["render.bin_mesh"]) == 3
    assert 0.95 * total <= phases <= total


def test_no_range_opens_without_a_profiler(monkeypatch):
    """With no profiler running, a relocalization and a front-end run
    (synchronous mapping) never open a range, and the records keep only the
    newest frames and keyframes (the bounds cut to 6 and 2)."""
    def refuse(name, *a, **k):
        raise AssertionError(f"range {name} opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(fp, "FRAME_RECORDS", 6)
    monkeypatch.setattr(local_mapping, "KEYFRAME_RECORDS", 2)
    loc, frame, T = small_relocalization()
    loc.relocalize_strategy(frame, T)

    _, frames, poses = e2e_frames()
    sys_ = SLAMSystem(e2e_config(), use_nmi=False, output_dir=tempfile.mkdtemp(),
                      device="cpu")
    sys_.set_init_poses(poses[0], poses[4])
    fe = fp.PipelinedFrontend(sys_, n_cand=1024)
    try:
        results = fe.run(frames, TS)
        assert sum(r is not None and r.state.name == "OK" for r in results) >= N_FRAMES - 6
        newest = list(range(N_FRAMES - 6, N_FRAMES))
        assert list(fe.records) == list(fe.completion_walls) == newest
        assert all(fe.records[f]["t_done_ns"] > 0 for f in newest)
        recs = sys_.local_mapper.records
        assert len(recs) == 2 and recs[-1]["kf"] == sys_.map.n_keyframes - 1
    finally:
        sys_.shutdown()


def test_newest_keeps_the_newest_keys():
    d = profiling.Newest(3)
    for k in range(10):
        d[k] = k * 10
    d[8] = -1  # a key set again keeps its place
    assert list(d.items()) == [(7, 70), (8, -1), (9, 90)]
    d[10] = 100
    assert list(d) == [8, 9, 10]


def test_setup_counters_keep_the_first_reading(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "SETUP", {})
    path = str(tmp_path / "voc.npz")
    Vocabulary.synthetic(4, 2, seed=0).save(path)
    Vocabulary.load(path)
    first = profiling.SETUP["vocabulary.load"]
    Vocabulary.load(path)
    assert profiling.SETUP["vocabulary.load"] == first and first[0] > 0.0

    # an initialization's latches, each once a process; none without a localizer
    def latch(frame, initializing):
        time.sleep(0.01)

    tracker = types.SimpleNamespace(nmi=object(), _run_nmi=latch)
    for _ in range(2):
        Tracker._init_latch(tracker, None, "nmi.init_latch.1")
    Tracker._init_latch(tracker, None, "nmi.init_latch.2")
    Tracker._init_latch(types.SimpleNamespace(nmi=None), None, "nmi.init_latch.3")
    assert set(profiling.SETUP) == {"vocabulary.load", "nmi.init_latch.1", "nmi.init_latch.2"}
    assert profiling.SETUP["nmi.init_latch.1"][0] >= 0.01
    assert profiling.SETUP["nmi.init_latch.1"][1] < profiling.SETUP["nmi.init_latch.2"][1]


def test_cloud_upload_is_no_setup_step_on_the_cpu(monkeypatch):
    monkeypatch.setattr(profiling, "SETUP", {})
    small_cloud_relocalization()
    assert "nmi.cloud_upload" not in profiling.SETUP


@pytest.mark.gpu
def test_cloud_upload_is_recorded_once_on_the_card(cuda_device, monkeypatch):
    """The localizer places a point model on the card in its set-up, and the
    counter keeps the first of two localizers' readings."""
    monkeypatch.setattr(profiling, "SETUP", {})
    loc, _, _ = small_cloud_relocalization(cuda_device)
    assert loc.model.points.device.type == "cuda"
    first = profiling.SETUP["nmi.cloud_upload"]
    small_cloud_relocalization(cuda_device)
    assert profiling.SETUP["nmi.cloud_upload"] == first and first[0] > 0.0
    assert "nmi.mesh_upload" not in profiling.SETUP
