"""The port's device-time budget (`orbslam2_nmi_torch/tools/device_budget.py`)
against the JAX package's `tools/device_budget.py`.

  * `classify` and `budget_from_module_times` give the JAX tool's result on
    the same input: the module names of STEADY_STATE_r05.json and the
    port's range names (`utils/profiling.NAMES`, from `labelled` and
    `span`), each of which lands in the bucket of the reference function it
    is named after; the phases that have no reference function (the
    front-end's, the NMI strategy's, the mapping worker's) land in "other",
    where their device time went before they had a range;
  * the attribution on a synthetic event list: a device operation is
    charged to the innermost named range open on its launching thread when
    it was launched, found from its host op or, where the profiler links it
    to none (a graph launched inside `fused_step`, a kernel launched through
    ctypes on a worker), from its CUDA API call (nested ranges, two
    threads); the profiler's device-side annotations are not counted,
    operations whose launch is not found go to "(no range)", and the union
    of overlapping intervals counts once;
  * on the CPU, `traced()` records the ranges of a thread started before
    the window;
  * on the card (the `gpu` marker): a profiled bench sweep at 128x256 puts
    B3 and the sampler in nmi_render and B1 and B2 in nmi_score.
"""

import json
import re
import threading
from pathlib import Path

import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch.tools import bench as tbench
from orbslam2_nmi_torch.tools import device_budget as tdb
from orbslam2_nmi_torch.utils import profiling
from orbslam2_nmi_tpu.tools import device_budget as jdb

ROOT = Path(__file__).resolve().parent.parent

# the bucket each of the port's ranges must land in
EXPECTED = {
    "fused_step": "tracking_fused_step", "fused_step.upload": "tracking_fused_step",
    "extract_orb": "orb_extraction", "rasterize_keys": "nmi_render",
    "render_gray": "nmi_render", "render_mesh_grid": "nmi_render",
    "render_translation_grid": "nmi_render", "render_pointcloud": "nmi_render",
    "render.bin_mesh": "nmi_render", "render.prepare_sweep": "nmi_render",
    "warp_rotation_grid": "nmi_warp", "warp_homographies": "nmi_warp",
    "joint_entropy_grid": "nmi_score", "marginal_entropy_grid": "nmi_score",
    "marginal_entropy_sets": "nmi_score", "entropy.nmi_scores": "nmi_score",
    "bundle_adjust": "bundle_adjustment", "pose_optimization": "pose_optimization",
    "pose_graph": "pose_graph", "sim3_ransac": "loop_closing", "optimize_sim3": "loop_closing",
    "match_descriptors": "matching", "match_epipolar_batch": "matching",
    "fuse_match_batch": "matching", "triangulate_and_gate_batch": "local_mapping",
    "pnp_ransac": "relocalization", "vocab_quantize": "place_recognition",
    "render.bin_mesh.build": "nmi_render", "render.bin_mesh.slab": "nmi_render",
    "render.bin_mesh.upload": "nmi_render", "render.splat.project": "nmi_render",
    "render.splat.scatter": "nmi_render", "render.splat.resolve": "nmi_render",
    "nmi.relocalize": "other", "nmi.sweep": "other", "nmi.readback": "other",
    "frontend.dispatch": "other", "frontend.map_lock": "other", "frontend.candidates": "other",
    "frontend.readback_wait": "other", "frontend.process": "other",
    "frontend.keyframe": "other", "frontend.nmi_backpressure": "other",
    "frontend.classic": "other", "mapping.keyframe": "other",
}


def test_buckets_match_reference():
    ref = json.loads((ROOT / "STEADY_STATE_r05.json").read_text())["top_modules_ms"]
    import orbslam2_nmi_torch.entry  # noqa: F401  (every labelled module)

    names = sorted(ref) + sorted(profiling.NAMES) + ["jit_reshape", "(no range)", "x"]
    assert tdb.BUCKETS == jdb.BUCKETS
    for name in names:
        assert tdb.classify(name) == jdb.classify(name), name
    in_source = set()
    for path in (ROOT / "orbslam2_nmi_torch").rglob("*.py"):
        in_source |= set(re.findall(r'(?:labelled|span)\("([^"]+)"\)', path.read_text()))
    assert in_source == set(EXPECTED) and in_source <= profiling.NAMES
    assert {n: tdb.classify(n) for n in in_source} == EXPECTED
    times = {n: 1e-3 * (i + 1) for i, n in enumerate(names)}
    for n_frames in (0, 1, 100):
        assert tdb.budget_from_module_times(times, n_frames) == \
            jdb.budget_from_module_times(times, n_frames)


class _Event:
    """A stand-in for the profiler's KinetoEvent."""

    def __init__(self, name, device, start, end, corr=0, linked=0, thread=1, stream=7,
                 annotation=False):
        self._v = dict(name=name, device=device, start=start, end=end, corr=corr, linked=linked,
                       thread=thread, stream=stream, annotation=annotation)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v["device"]
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._v["start"]

    def end_ns(self):
        return self._v["end"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def start_thread_id(self):
        return self._v["thread"]

    def device_resource_id(self):
        return self._v["stream"]

    def is_user_annotation(self):
        return self._v["annotation"]


class _Profile:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_device_ops_land_in_the_innermost_range():
    profiling.NAMES.update({"fused_step", "render_mesh_grid", "rasterize_keys",
                            "bundle_adjust"})
    ev = [
        # host events: profiler thread 1 is system thread 1001 (`stream`), 2 is
        # 1002; a CUDA API call outside every host op names no profiler thread
        # thread 1: the step's range, a graph launched in it
        _Event("fused_step", False, 0, 1000, corr=1, stream=1001),
        _Event("cudaGraphLaunch", False, 50, 60, corr=500, stream=1001),
        # thread 1: render_mesh_grid > rasterize_keys > an aten op
        _Event("render_mesh_grid", False, 2000, 3000, corr=2, stream=1001),
        _Event("rasterize_keys", False, 2100, 2500, corr=3, stream=1001),
        _Event("aten::copy_", False, 2200, 2300, corr=4, stream=1001),
        _Event("cudaLaunchKernel", False, 2210, 2220, corr=501, linked=4, stream=1001),
        _Event("aten::add", False, 2600, 2700, corr=5, stream=1001),  # in render_mesh_grid
        _Event("aten::mul", False, 4000, 4100, corr=6, stream=1001),  # outside every range
        # thread 2 (a worker): bundle_adjust around an aten op and a kernel
        # launched through ctypes, at times that overlap thread 1's ranges
        _Event("bundle_adjust", False, 2000, 5000, corr=7, thread=2, stream=1002),
        _Event("aten::mm", False, 2150, 2160, corr=8, thread=2, stream=1002),
        _Event("cudaLaunchKernel", False, 2155, 2158, corr=502, linked=8, thread=2,
               stream=1002),
        _Event("cudaLaunchKernel", False, 2170, 2175, corr=503, stream=1002),
        # the device's operations
        _Event("k_graph_a", True, 100, 300, corr=500),
        _Event("k_graph_b", True, 250, 400, corr=500),  # overlaps k_graph_a
        _Event("rasterize_keys_kernel(float const*)", True, 2400, 2450, linked=3),
        _Event("memcpy", True, 2460, 2470, corr=501, linked=4),
        _Event("add_kernel", True, 2800, 2810, linked=5),
        _Event("mul_kernel", True, 4200, 4220, linked=6),
        _Event("gemm", True, 2300, 2400, corr=502, linked=8, stream=9),
        _Event("render_gray_kernel", True, 2500, 2520, corr=503, stream=9),
        _Event("lost", True, 6000, 6005, corr=600, stream=9),  # no launch recorded
        _Event("no_host_op", True, 7000, 7003, linked=99),
        _Event("fused_step", True, 100, 400, annotation=True),  # a device-side annotation
    ]
    times, info = tdb.device_label_times(_Profile(ev))
    got = {k: round(v * 1e9) for k, v in times.items()}
    assert got == {"fused_step": 350, "rasterize_keys": 60, "render_mesh_grid": 10,
                   "(no range)": 20 + 5 + 3, "bundle_adjust": 120}
    assert info["n_device_ops"] == 10
    assert round(info["device_busy_s"] * 1e9) == 200 + 150 + 50 + 10 + 10 + 20 + 100 + 20 + 8
    assert round(info["device_union_s"] * 1e9) == 300 + 100 + 50 + 10 + 20 + 10 + 20 + 8
    assert info["unattributed_ms_by_stream"] == {"9": 5e-6, "7": 3e-6}
    assert info["cuda_kernels_ms"] == {"rasterize_keys_kernel": {"rasterize_keys": 5e-5},
                                       "render_gray_kernel": {"bundle_adjust": 2e-5}}


def test_traced_records_other_threads():
    """A worker thread started before the window, as the system's are."""
    @profiling.labelled("worker_range_probe")
    def work():
        return torch.ones(64).sum()

    go = threading.Event()

    def worker():
        work()
        go.wait()
        work()

    t = threading.Thread(target=worker)
    t.start()
    with tdb.traced("cpu") as prof:
        go.set()
        t.join()
        work()
    threads = {e.start_thread_id() for e in prof.profiler.kineto_results.events()
               if e.name() == "worker_range_probe"}
    assert len(threads) == 2


def test_cli_device_choices():
    with pytest.raises(SystemExit):
        tdb.main(["--device", "tpu"])


@pytest.mark.gpu
def test_bench_sweep_kernels_land_in_render_and_score(cuda_device):
    """A bench sweep at 128x256, profiled on the main thread and on a
    worker started before the window (as the system's workers are): each
    hand-written kernel lands in its bucket from both."""
    inp = tbench.sweep_inputs(cuda_device, 128, 256)
    tbench.run_sweep(inp, reps=1, warmup=1)  # builds the kernels
    stages = tbench.stages(inp)

    def sweep():
        return tbench.histogram_nmi.nmi_scores(stages["render"](), stages["warp"]())

    go, out = threading.Event(), []

    def worker():
        go.wait()
        out.append(sweep())
        torch.cuda.synchronize()

    t = threading.Thread(target=worker)
    t.start()
    with tdb.traced(cuda_device) as prof:
        scores = sweep()
        go.set()
        t.join()
        torch.cuda.synchronize()
    assert scores.shape == out[0].shape == (27, 27)
    times, info = tdb.device_label_times(prof)
    budget = tdb.budget_from_module_times(times, 1)["by_subsystem_ms"]
    assert times.get("render_gray", 0) > 0 and times.get("rasterize_keys", 0) == 0
    assert times.get("joint_entropy_grid", 0) > 0 and times.get("marginal_entropy_sets", 0) > 0
    where = {k: {tdb.classify(r) for r in v} for k, v in info["cuda_kernels_ms"].items()}
    assert where == {"render_gray_kernel": {"nmi_render"}, "joint_entropy_kernel": {"nmi_score"},
                     "marginal_entropy_kernel": {"nmi_score"}}
    assert budget["nmi_render"] > 0 and budget["nmi_score"] > 0 and budget["nmi_warp"] > 0
    assert info["n_device_ops"] > 0 and info["launch_found_ms"]["not_found"] == 0
