"""The harness finds everything by name, and a run's last line has the
contract's shape."""

import json
import subprocess
import sys

import pytest

from slambench import run
from slambench.tests.conftest import CELLS, ROOT, small_config, small_traffic


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark()


def test_every_cell_is_found_by_name(bench):
    for w in bench["workloads"]:
        entry, cfg, traffic = run.find_cell(bench, w["name"])
        assert entry["config"] == cfg["name"]
        assert (ROOT / "slambench" / "drivers" / f"{traffic['kind']}.py").exists()
        assert set(run.load_limits(w["name"]))
    with pytest.raises(KeyError):
        run.find_cell(bench, "no-such-cell")


def test_every_metric_has_its_reader_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        e2e, layer = run.cell_metrics(bench, w)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert all(m["moves"] in names for m in layer)


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mesh-reloc", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_outside_a_checkout_there_is_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    the run fails and prints no result (the program is not there)."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload", "mesh-reloc", "--seed",
                        "7", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_last_line_shape(workload):
    out = run.run_cell(workload, 2**31 + 11, 4.0, False, "cpu", cfg=small_config(CELLS[workload]),
                       traffic=small_traffic())
    line = json.loads(json.dumps(out))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "check"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and 0 <= line["failed"] <= line["attempted"]
    e2e, _ = run.cell_metrics(run.load_benchmark(), workload)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}
