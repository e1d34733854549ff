"""The readings a cell's limits are set from, on the card, in one process.

    python3 slambench/tools/readings.py --workload mesh-reloc --seconds 6 \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--out readings.jsonl]

For each of `--seeds`: the program's run of the cell (set-up, a window of
`--seconds`, the check), as `run.py` makes it, with `--fault` planted if
given (`slambench/faults.py`). For each of
`--control-seeds`: the control, the plain reference computed one precision
below the configuration's (bfloat16 images) put in the program's place,
judged by the same check (`control_numbers`). One JSON line per run: its compared numbers.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import run  # noqa: E402
from slambench.faults import FAULTS  # noqa: E402


def control_numbers(workload: str, seed: int, seconds: float) -> dict:
    """The control's numbers: a window of the program gives the inputs that
    only a run has (a live cell's anchors and sampled frames), the reference
    at bfloat16 makes the outputs in the program's place, and the check
    judges them as it judges the program's."""
    import importlib

    import torch

    _, cfg, traffic = run.find_cell(run.load_benchmark(), workload)
    driver = importlib.import_module(f"slambench.drivers.{traffic['kind']}")
    cell = driver.Cell(cfg, traffic, seed, torch.device("cuda"), seconds)
    cell.warmup()
    res = cell.window(seconds, keep=cell.keep_indices())
    cell.free_program()
    return cell.check(cell.control(res))


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant this fault under the program's runs (its readings)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            if kind == "program":
                out = run.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                   patch=FAULTS.get(args.fault))
                numbers = dict(out["compared"], **{k: v["value"] for k, v in out["check"].items()})
                extra = dict(attempted=out["attempted"], failed=out["failed"],
                             metrics={k: v["value"] for k, v in out["metrics"].items()})
            else:
                numbers = control_numbers(args.workload, seed, args.seconds)
                extra = {}
            line = json.dumps(dict(workload=args.workload, kind=kind, fault=args.fault, seed=seed,
                                   numbers=numbers, seconds=time.perf_counter() - t0, **extra))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
