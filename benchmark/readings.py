"""The readings a cell's limits are set from: for each seed, a run of the
cell at its own size (a short window), then its check with the control
read beside the program:

    python benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 5

One JSON line per seed: the program's numbers and the control's
(``control_<number>``: the reference one precision lower in the program's
place).  Not part of a benchmark run.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import harness, tracing  # noqa: E402


def readings(workload: str, seeds, seconds: float, device=None,
             root: pathlib.Path = harness.ROOT):
    cell = harness.load_cell(workload, root)
    if device is None:
        device = harness.require_cards(cell.chips)
    harness.configure(device)
    mod = harness.driver(cell.traffic["driver"], root)
    for seed in seeds:
        ctx = harness.Context(
            cell=cell, seed=seed, seconds=seconds, trace=False,
            device=device, tracer=tracing.Tracer(False, 1, device),
            t0=time.perf_counter())
        st = mod.setup(ctx)
        win = mod.window(ctx, st)
        numbers = mod.check(ctx, st, win, control=True)
        yield {"workload": workload, "seed": seed, "numbers": numbers,
               "metrics": win.metrics}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(args.workload, seeds, args.seconds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
