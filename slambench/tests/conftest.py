"""Shared pieces of the benchmark's own tests: small configurations that run
on the CPU, and the `gpu` marker with the fixture that decides, at run time,
whether a card is there (never while a module is imported)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import run  # noqa: E402


def _reloc_cells() -> dict:
    """Every cell of `BENCHMARK.json` whose traffic's kind is `reloc`, mapped
    to its configuration's name: a cell added by files alone gets the CPU
    tests of its program, control and faults."""
    bench = run.load_benchmark()
    return {w["name"]: w["config"] for w in bench["workloads"]
            if run.find_cell(bench, w["name"])[2]["kind"] == "reloc"}


CELLS = _reloc_cells()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card with `python -m pytest slambench/tests -m gpu`")
    return torch.device("cuda")


def small_config(name: str) -> dict:
    """The configuration at 128x72 on a 40x40 terrain: the same code paths,
    small enough for the CPU's plain versions."""
    with open(ROOT / "slambench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["camera"].update(fx=60.0, fy=60.0, cx=64.3, cy=36.2, width=128, height=72)
    cfg["prior"].update(grid=40, texture=128)
    if "cloud_density" in cfg["prior"]:
        cfg["prior"]["cloud_density"] = 6.0
    return cfg


def small_traffic(name: str = "reloc_stream") -> dict:
    with open(ROOT / "slambench" / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    traffic = copy.deepcopy(traffic)
    traffic.update(pool=6, warmup_requests=1)
    traffic["check"].update(image_within=2, image_requests=2, pose_requests=3)
    return traffic


def small_live() -> tuple:
    """(configuration, traffic) of the live cell at 240x135 with 300
    features on a 60x60 terrain: the whole system on the CPU in minutes."""
    with open(ROOT / "slambench" / "configs" / "zumav_mesh.json") as f:
        cfg = json.load(f)
    cfg["camera"].update(fx=112.5, fy=112.5, cx=120.2, cy=67.4, width=240, height=135)
    cfg["orb"]["n_features"] = 300
    cfg["prior"].update(grid=60, texture=256)
    with open(ROOT / "slambench" / "traffic" / "live_circuit.json") as f:
        traffic = json.load(f)
    traffic["frames_per_second"] = 3
    traffic["check"].update(orb_within=20, orb_frames=2)
    return cfg, traffic
