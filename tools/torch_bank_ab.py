#!/usr/bin/env python3
"""Host and device time of the harmonic-bank wrappers, and of the bank
kernels across tilings.

    python3 tools/torch_bank_ab.py [--tree DIR]   # DIR's public wrappers
    python3 tools/torch_bank_ab.py --sweep        # this tree's tilings

Default: the public ``harmonic_bank`` and ``harmonic_bank_bwd`` of the
checkout DIR (by default the one that holds this script; any commit whose
wrappers take (amps_l, amps_r, phi, frac[, g]) with frac [hop]) on seeded
inputs at the main paths' widths: the forward at R = 20, 100, 800 and 1280
rows, the backward at R = 100 and 800 (H = 161, hop 120).  Per call: the
error against the plain version, device µs (``chip_smoke.device_ms``:
``torch.profiler`` over 50 calls) and host µs (``chip_smoke.host_us``: the
enqueue, a mean over 200 calls; and the least of 20 means over 50 calls,
which the shared host's noise moves less).  To compare two commits, unpack the other with ``git archive``
into a directory ``.gitignore`` lists and run this once per tree in turns
(other, this, this, other), each in its own process.

``--sweep``: this tree's kernels launched directly with a grid of the
tilings the launchers take (samples per lane 1, 2, 4; forward: one sample
warp or one per chunk, rows per block 1, 2, 4; backward: harmonic segments
1, 3, 5) at the same widths, each checked against the plain version; marks
the plan ``bank_plan`` chooses.  It is how FWD_TARGET_WARPS and
BWD_TARGET_WARPS in ``ops/harmonic_bank.py`` were chosen.

Every run prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent.parent
FWD_ROWS = (20, 100, 800, 1280)
BWD_ROWS = (100, 800)


def load_chip_smoke():
    """This checkout's ``chip_smoke`` (its timing helpers and seeded
    inputs), whichever tree the package is imported from."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def host_best_us(fn, rounds: int = 20, iters: int = 50) -> float:
    """Host time of one call in us, the least of ``rounds`` means over
    ``iters`` calls (the device synced between rounds, not inside): the
    wrapper's own cost, less the shared host's noise than one mean."""
    import time

    import torch
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return best


def error(outs, refs) -> float:
    """Worst output's max |kernel - plain| over the plain output's peak."""
    return max(float((o - p).abs().max() / p.abs().max())
               for o, p in zip(outs, refs))


def wrappers(cs, dev) -> None:
    """The imported tree's public bank wrappers: error, device and host
    time per call."""
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb

    print(f"[tree] {pathlib.Path(hb.__file__).resolve().parents[2]}")
    cuda.build([cuda.HARMONIC_BANK, cuda.HARMONIC_BANK_BWD])
    cfg = Config()
    H, hop = cfg.dsp.num_harmonics, cfg.dsp.hop
    for backward, rows in ((False, FWD_ROWS), (True, BWD_ROWS)):
        name = "harmonic_bank_bwd" if backward else "harmonic_bank"
        for R in rows:
            al, ar, phi, frac, g = cs.bank_inputs(
                R, H, hop, dev, np.random.default_rng(R))
            if backward:
                run = lambda: hb.harmonic_bank_bwd(al, ar, phi, frac, g)
                refs = hb.harmonic_bank_bwd_plain(al, ar, phi, frac, g)
            else:
                run = lambda: (hb.harmonic_bank(al, ar, phi, frac),)
                refs = (hb.harmonic_bank_plain(al, ar, phi, frac),)
            err = error(run(), refs)
            print(f"[wrapper] {name} R={R}: device "
                  f"{cs.device_ms(run) * 1e3:.3f} us, host "
                  f"{cs.host_us(run):.1f} us/call (best of 20 rounds "
                  f"{host_best_us(run):.1f}), error /peak vs plain "
                  f"{err:.3e}")


def sweep(cs, dev) -> None:
    """This tree's kernels at every tiling the launchers take."""
    import torch

    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb

    cfg = Config()
    H, hop = cfg.dsp.num_harmonics, cfg.dsp.hop
    for backward, rows in ((False, FWD_ROWS), (True, BWD_ROWS)):
        name = "harmonic_bank_bwd" if backward else "harmonic_bank"
        kern = cuda.HARMONIC_BANK_BWD if backward else cuda.HARMONIC_BANK
        for R in rows:
            al, ar, phi, frac, g = cs.bank_inputs(
                R, H, hop, dev, np.random.default_rng(R))
            ins = [t.data_ptr() for t in (al, ar, phi, frac)]
            if backward:
                outs = [torch.empty(s, device=dev) for s in
                        ((R, H), (R, H), (R, hop), (R, hop))]
                ins.append(g.data_ptr())
                refs = hb.harmonic_bank_bwd_plain(al, ar, phi, frac, g)
            else:
                outs = [torch.empty((R, hop), device=dev)]
                refs = (hb.harmonic_bank_plain(al, ar, phi, frac),)
            chosen = hb.bank_plan(R, H, hop, backward=backward)
            plans = {chosen}
            for spl in hb.SAMPLES_PER_LANE:
                chunks = -(-hop // (hb.WARP * spl))
                if backward:
                    plans |= {hb.BankPlan(spl, S, 1, 1) for S in (1, 3, 5)}
                else:
                    plans |= {hb.BankPlan(spl, 1, T, rows_)
                              for T in {1, chunks} for rows_ in (1, 2, 4)}
            for plan in sorted(plans):
                def run(plan=plan):
                    kern.launch(*ins, *(o.data_ptr() for o in outs), R, H,
                                hop, *plan.launch_args(backward))
                    return outs
                err = error(run(), refs)
                mark = " (bank_plan)" if plan == chosen else ""
                print(f"[sweep] {name} R={R} samples/lane "
                      f"{plan.samples_per_lane} segments {plan.segments} "
                      f"sample warps {plan.sample_warps} rows/block "
                      f"{plan.rows_per_block}: device "
                      f"{cs.device_ms(run) * 1e3:.3f} us, error /peak "
                      f"{err:.3e}{mark}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tree", type=pathlib.Path, default=HERE,
                      help="checkout whose bank wrappers to time")
    mode.add_argument("--sweep", action="store_true",
                      help="time this tree's kernels at every tiling")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_bank_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs = load_chip_smoke()
    if args.sweep:
        sweep(cs, dev)
    else:
        wrappers(cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
