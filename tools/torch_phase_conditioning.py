#!/usr/bin/env python3
"""How far float32 rounding moves the renderer's frame-boundary phases, on
the CPU.

    python3 tools/torch_phase_conditioning.py

The renderer's boundary phase of frame i is the prefix sum of the frame
phase increments since the last voicing reset, taken mod 2 pi
(``dsp/synthesis.py:integrate_phase``).  Over a streaming chunk (20
frames) the sum stays below ~15 rad; over a whole utterance (the offline
render) it reaches thousands, where float32 rounds each sum by ~1e-4 rad
and harmonic h multiplies that by h.  On chip_smoke.py's 3 s signal (a
harmonic stack to 0.9 of Nyquist) this prints, for the whole utterance
and for one chunk, the largest boundary difference between a float32 and
a float64 prefix sum and the harmonic render's difference between the two
(the plain harmonic bank, relative to its peak).  The port sums in float64;
the JAX package's renderer sums in float32.
"""

from __future__ import annotations

import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def boundaries(inc, reset_idx, dtype):
    """Boundary phases mod 2 pi from per-frame increments, the prefix sum
    in ``dtype``."""
    import torch
    csum = torch.cat([torch.zeros(1, dtype=dtype),
                      torch.cumsum(inc.to(dtype), dim=0)])
    adv = csum[:-1] - csum[reset_idx]
    return torch.remainder(adv, 2.0 * math.pi).double()


def main() -> int:
    import torch

    import chip_smoke
    from realtime_yukarin_tpu_torch.config import DspConfig
    from realtime_yukarin_tpu_torch.dsp.synthesis import (SynthCarry,
                                                          integrate_phase,
                                                          synthesis_controls)
    from realtime_yukarin_tpu_torch.dsp.world import analyze
    from realtime_yukarin_tpu_torch.ops.harmonic_bank import (
        harmonic_bank_plain)

    cfg = DspConfig()
    x = chip_smoke.test_signal(chip_smoke.SECONDS, cfg.sample_rate,
                               chip_smoke.SEED)
    F = len(x) // cfg.hop
    feat = analyze(torch.from_numpy(x), F, cfg)
    ext = [torch.cat([t, t[-1:]]) for t in (feat.f0, feat.env, feat.ap)]
    amps, _, f0f, voiced = synthesis_controls(*ext, cfg)
    for label, n in (("whole utterance", F), ("one 100 ms chunk", 20)):
        track = integrate_phase(f0f[:n + 1], voiced[:n + 1], cfg,
                                SynthCarry.zeros(cfg, "cpu"))
        inc = (track.phi[:, -1] - track.boundaries).double()
        # the last voicing reset at or before each frame (none before the
        # first frame: the carry is unvoiced)
        v = voiced[:n]
        cont = v & torch.cat([torch.zeros(1, dtype=torch.bool), v[:-1]])
        reset = torch.cummax(torch.where(cont, -1, torch.arange(n)),
                             0).values
        b32 = boundaries(inc, reset, torch.float32)
        b64 = boundaries(inc, reset, torch.float64)
        d = torch.remainder(b32 - b64 + math.pi, 2 * math.pi) - math.pi
        cum = (track.phi - track.boundaries[:, None]).double()
        out = {}
        for name, b in (("f32", b32), ("f64", b64)):
            out[name] = harmonic_bank_plain(
                amps[:n].double(), amps[1:n + 1].double(),
                b[:, None] + cum, track.frac.double())
        peak = float(out["f64"].abs().max())
        err = float((out["f32"] - out["f64"]).abs().max()) / peak
        csum = torch.cat([torch.zeros(1, dtype=inc.dtype), inc.cumsum(0)])
        since = float((csum[:-1] - csum[reset]).max())
        print(f"[phase] {label} ({n} frames, prefix sum to "
              f"{float(csum[-1]):.0f} rad, {since:.0f} since a reset): "
              f"boundary float32 - float64 max {float(d.abs().max()):.2e} "
              f"rad; harmonic render {err:.2e} of its peak")
    return 0


if __name__ == "__main__":
    sys.exit(main())
