"""The cloud cell's readers: the splat's bytes from shapes, nothing read
without a point cloud or the splat's ranges, the ranges found once a sweep
in a small traced run on the CPU, and both readings in a traced run on the
card."""

import types

import pytest

from slambench import run, splat_work, trace
from slambench.tests.conftest import small_config, small_traffic

READERS = ("splat.device_ms", "splat_roofline")


def test_splat_bytes_from_shapes():
    # the deployment: 2,184,253 points, 27 candidates at 960x540
    assert splat_work.splat_bytes(2_184_253, 27, 540, 960) == 34_948_048 + 55_987_200 == 90_935_248
    assert splat_work.splat_bytes(10, 1, 2, 3) == 160 + 24


CAMERA = dict(height=540, width=960)
SWEEP = dict(num_synth=(3, 3, 3), num_warp=(3, 3, 3), scale=1)


def _ctx(names=splat_work.RANGES, points=True):
    """A reader's context: one sweep, whose trace holds `names` with device
    time, of a cell with or without a point cloud."""
    tr = trace.Trace(window_s=1.0, busy_s=0.5, range_device_s={n: 0.01 for n in names},
                     range_host={n: (1, 0.01) for n in (*names, "render.prepare_sweep")})
    res = dict(t_start=0.0, requests=[dict(sweeps=[SWEEP])], overrun=dict(sweeps=[]))
    cell = types.SimpleNamespace(points=[[0.0] * 3] * 4 if points else None,
                                 cfg=dict(camera=CAMERA))
    return types.SimpleNamespace(trace=tr, res=res, cell=cell)


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_a_cloud_with_the_spans(metric):
    assert run.load_reader(metric)(_ctx()) > 0.0


@pytest.mark.parametrize("case", ["no counters", "no spans", "no points"])
@pytest.mark.parametrize("metric", READERS)
def test_readers_read_nothing_without_the_spans_or_points(metric, case):
    """A program without the splat's ranges, or a cell without a point cloud
    (a mesh cell), gives no reading."""
    if case == "no counters":
        ctx = types.SimpleNamespace(trace=trace.Trace(), res=_ctx().res, cell=None)
    elif case == "no spans":
        ctx = _ctx(names=("render_gray",))
    else:
        ctx = _ctx(points=False)
    assert run.load_reader(metric)(ctx) is None


def test_splat_ranges_open_once_a_sweep_on_the_cpu(monkeypatch):
    """A small traced cloud-reloc run: the trace holds each of the splat's
    ranges once a sweep (on the CPU there is no device time, so neither
    reader reads)."""
    seen = {}
    read = trace.read

    def reading(prof, names):
        seen["trace"] = read(prof, names)
        return seen["trace"]

    def keep_window(cell):
        window = cell.window

        def kept(*args, **kwargs):
            seen["res"] = window(*args, **kwargs)
            return seen["res"]

        cell.window = kept

    monkeypatch.setattr(trace, "read", reading)
    line = run.run_cell("cloud-reloc", 2**31 + 23, 4.0, True, "cpu",
                        cfg=small_config("zumav_cloud"), traffic=small_traffic(),
                        patch=keep_window)
    assert line["correct"], line["check"]
    res = seen["res"]
    n = sum(len(r["sweeps"]) for r in res["requests"] + [res["overrun"]])
    assert n >= 1
    for name in splat_work.RANGES:
        assert seen["trace"].range_host[name][0] == n, name
    assert not set(READERS) & set(line["metrics"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["cloud-reloc"])
def test_traced_run_reads_the_splat_on_the_card(cuda_device, workload):
    line = run.run_cell(workload, 2**31 + 29, 4.0, True, "cuda")
    assert line["correct"], line["check"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["splat.device_ms"] > 0.0
    assert 0.0 < m["splat_roofline"] <= 100.0
    opened = {name for name, _ in line["breakdown"]["device_ops"]}
    assert {"render.splat.project", "render.splat.scatter", "render.splat.resolve"} <= opened
