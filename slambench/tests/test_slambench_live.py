"""The live cell at 240x135 on the CPU: the reference agrees with the
program's anchors and extraction, and a fault under the tracking step makes
`correct` false. At this size the tracker's error against the generator's
poses is not the full-size cell's (PERF.md), so the sound run is held on
every other number."""

import pytest

from slambench import run
from slambench.faults import FAULTS
from slambench.tests.conftest import small_live

SEED = 2**31 + 77


def _run(seconds, patch=None):
    cfg, traffic = small_live()
    return run.run_cell("mesh-live", SEED, seconds, False, "cpu", cfg=cfg, traffic=traffic,
                        patch=patch)


def test_live_agrees_with_the_reference():
    # long enough for the asynchronous NMI worker to land anchors on the CPU
    out = _run(60.0)
    assert out["compared"]["anchors_compared"] >= 1 and out["compared"]["orb_frames"] >= 1
    bad = {k: v for k, v in out["check"].items()
           if k != "track_err_m" and v["value"] > v["limit"]}
    assert not bad, bad
    assert out["attempted"] > 0 and set(out["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                                            "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer"])
def test_live_fault_is_not_correct(fault):
    out = _run(25.0, FAULTS[fault])
    assert not out["correct"], out["check"]


@pytest.mark.gpu
def test_live_cell_on_the_card(cuda_device):
    out = run.run_cell("mesh-live", SEED, 8.0, False, "cuda")
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"
