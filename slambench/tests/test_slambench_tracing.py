"""The readers of the program's spans and counters: each returns a number in
a small traced run of its cell on the CPU, and nothing, without raising,
where the program keeps no such span or counter."""

import types

import pytest

from slambench import run, trace
from slambench.tests.conftest import small_config, small_live, small_traffic

RELOC = ("bin.build_ms", "bin.slab_ms", "bin.upload_ms", "setup.program_s")
LIVE = ("frontend.nmi_backpressure_ms", "frontend.keyframe_ms", "track.step_host_ms",
        "mapping.queue_ms", "setup.program_s")


def test_reloc_readers_read_a_traced_run():
    out = run.run_cell("mesh-reloc", 2**31 + 11, 10.0, True, "cpu",
                       cfg=small_config("zumav_mesh"), traffic=small_traffic())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(RELOC) <= set(m), m
    assert all(m[k] >= 0.0 for k in RELOC)
    # the binning's phases lie inside the sweep's host stage
    assert 0.0 < m["bin.build_ms"] + m["bin.slab_ms"] + m["bin.upload_ms"] <= m["sweep.prepare_ms"]


def test_live_readers_read_a_traced_run():
    # long enough on the CPU for keyframes and their mapping after the traced stretch
    cfg, traffic = small_live()
    out = run.run_cell("mesh-live", 2**31 + 77, 60.0, True, "cpu", cfg=cfg, traffic=traffic)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(LIVE) <= set(m), m
    assert all(m[k] >= 0.0 for k in LIVE)
    # the vocabulary's load and the NMI init latches, before the window
    assert m["setup.program_s"] > 0.0 and m["track.step_host_ms"] > 0.0


@pytest.mark.parametrize("metric", sorted(set(RELOC + LIVE)))
def test_readers_read_nothing_without_the_counters(metric, monkeypatch):
    """A program without the spans, the record fields or the set-up counters
    (the parent of the change that brought them) gives no reading."""
    from orbslam2_nmi_torch.utils import profiling

    monkeypatch.delattr(profiling, "SETUP")
    res = dict(t_start=0.0, records={1: dict(path="fused", wait_ms=1.0), 2: None},
               mapping=[dict(kf=2, total_ms=3.0)])
    ctx = types.SimpleNamespace(trace=trace.Trace(), res=res, cell=None)
    assert run.load_reader(metric)(ctx) is None
