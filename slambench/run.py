"""Run one cell of the benchmark once and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and per-layer readers are found by the names `BENCHMARK.json` gives:
`slambench/configs/<config>.json`, `slambench/traffic/<traffic>.json`
(whose `kind` names the driver, `slambench/drivers/<kind>.py`),
`slambench/limits/<cell>.json` and `slambench/metrics/<metric>.py`.

A run builds the cell's world, its requests and the program (the seed draws
what the traffic mix leaves to it) and warms up (set-up),
measures for `--seconds`, then judges what the timed path produced against
the plain reference (`slambench/reference/`). With `--trace 0` the result's
metrics are the cell's end-to-end metrics; with `--trace 1` the window runs
under the profiler and they are its per-layer metrics. The numbers compared
are printed, each beside its limit, as the last lines on standard error and
under the result's last key, "check". The result is the last line on
standard output. A machine without as many CUDA devices as the cell asks for
gets no result and a non-zero exit.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The `time.perf_counter()` reading at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# what no run may load (compared by whole top-level module names)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam2_nmi_tpu")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> tuple:
    """(workload entry, its configuration's dict, its traffic's dict)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[w["config"]]["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return w, cfg, traffic


def load_limits(name: str) -> dict:
    with open(HERE / "limits" / f"{name}.json") as f:
        return json.load(f)["limits"]


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str) -> tuple:
    """(end-to-end entries, per-layer entries) this cell reports."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if ("workloads" in m and workload in m["workloads"])
             or ("workloads" not in m and m["moves"] in e2e_names)]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer reader reads: the window's records, the trace and the cell."""

    def __init__(self, cell, res, tr):
        self.cell, self.res, self.trace = cell, res, tr


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cfg: dict | None = None, traffic: dict | None = None, bench: dict | None = None,
             patch=None) -> dict:
    """One run of one cell; returns the result line's object. `cfg` and
    `traffic` replace the cell's files (the tests run small ones on the
    CPU); `patch`, if given, is called with the built cell before the
    warm-up (the tests break the timed path through it)."""
    import torch

    bench = bench or load_benchmark()
    seed = int(seed) % 2**63  # numpy's and torch's generators take non-negative seeds
    w, cfg_file, traffic_file = find_cell(bench, workload)
    cfg, traffic = cfg or cfg_file, traffic or traffic_file
    driver = importlib.import_module(f"slambench.drivers.{traffic['kind']}")
    from slambench import trace as tracing
    from orbslam2_nmi_torch.utils import profiling

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cell = driver.Cell(cfg, traffic, seed, dev, seconds)
    if patch is not None:
        patch(cell)
    cell.warmup()
    keep = cell.keep_indices()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_PROCESS
    tr = None
    tracer = tracing.Tracer() if trace else None
    res = cell.window(seconds, tracer=tracer, keep=keep)
    if cuda:
        torch.cuda.synchronize(dev)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    e2e, layer = cell_metrics(bench, workload)
    metrics: dict = {}
    if trace:
        tr = tracing.read(tracer.prof, profiling.NAMES | set(cell.RANGES))
        tracer.prof = None
        ctx = Context(cell, res, tr)
        for m in layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        measured = cell.end_to_end(res, seconds)
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in measured:
                metrics[m["name"]] = {"value": float(measured[m["name"]][0]), "unit": m["unit"]}
    attempted, failed = cell.attempted_failed(res)

    # the program's state goes before the reference runs on the same device
    cell.free_program()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = cell.check(res)
    limits = load_limits(workload)
    check = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    correct = all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": memory_peak}}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tracing.breakdown(tr)
    out["compared"] = {k: v for k, v in numbers.items() if k not in limits}
    out["check"] = check
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache of a run at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    bench = load_benchmark()
    w, _, _ = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"slambench: {args.workload} needs {w['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench=bench)
    found = forbidden_modules()
    if found:
        print(f"slambench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"check correct = {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
