#!/usr/bin/env python3
"""How well float32 determines the wave decoder's training gradient, leaf
by leaf.

    python3 tools/torch_wave_grad_conditioning.py [--device cuda] [--batch 2]

At the default Config (full width), with chip_smoke.py's perturbed weights
and its training-parity batch (``make_batch`` on the CPU, seed SEED + 11,
100 frames per utterance), it takes the gradient of the training step's
only term that reads the wave decoder, 0.5 * ``multi_resolution_stft`` of
``waveform_vocode`` against the real target waveform, with respect to
every leaf of the wave decoder:

- in float64 on the CPU: the witness.  The harmonic bank runs as its plain
  version under autograd, since the kernels take float32 only;
- in float32 on the CPU (the plain versions), as ``loss_and_grads`` does;
- in float32 on CUDA (the kernels), with ``--device cuda``.

For each leaf it prints the float64 gradient's peak, and each float32
gradient's max error over that peak and its cosine against it; with
``--device cuda`` also CUDA against the CPU in float32.  Then, for the
render's Jacobian J alone, each float32 run's J^T c64 against float64's,
c64 the float64 loss cotangent.  A leaf whose
float32 gradient on the CPU is far from the float64 one is not determined
by float32 arithmetic, so two float32 implementations cannot be held to
agree on it either.  It also prints the largest unwrapped phase advance
that multiplies the fractional ratios, and for each STFT resolution the
bins of the render with the smallest magnitude, which the loss weighs
most.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import pathlib
import sys
from unittest import mock

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def wave_term_grads(net, batch, cfg, dtype, cotangent=None
                    ) -> tuple[dict, object]:
    """({leaf name: d (0.5 * wave STFT loss) / d leaf} of ``net``, under
    "(cotangent)" d (that loss) / d the rendered waveform c, and, given
    another ``cotangent`` c', under "<leaf> at c64" the leaf's J^T c'; the
    rendered waveform)."""
    import torch
    from realtime_yukarin_tpu_torch.models.vocoder_wave import (
        waveform_vocode)
    from realtime_yukarin_tpu_torch.training import losses
    b = batch
    out, _ = waveform_vocode(net, b.f0_voc, b.env_voc, b.ap_voc, b.mc_voc,
                             b.noise, cfg.vocoder_wave, cfg.dsp, dtype=dtype)
    loss = 0.5 * losses.multi_resolution_stft(out, b.wave_voc)
    names, leaves = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, [*leaves, out],
                                retain_graph=cotangent is not None)
    res = {**dict(zip(names, grads)), "(cotangent)": grads[-1]}
    if cotangent is not None:
        at = torch.autograd.grad(out, list(leaves), grad_outputs=cotangent.to(
            out.device, out.dtype))
        res.update({f"{n} at c64": g for n, g in zip(names, at)})
    return res, out.detach()


def compare(a, ref) -> tuple[float, float]:
    """(max |a - ref| / max |ref|, cosine) in float64 on the host."""
    import torch
    x = a.detach().cpu().double().flatten()
    y = ref.detach().cpu().double().flatten()
    peak = float(y.abs().max())
    err = float((x - y).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(x, y, dim=0))
    return (err / peak if peak > 0 else err), cos


def smallest_bins(wave64, waves: dict, n: int = 3) -> None:
    """The loss's log-magnitude term weighs a bin by 1 / (|X| + 1e-6): for
    each resolution, print the ``n`` bins of the render with the smallest
    float64 |X| (utterance, frame, bin), their real part in float64 and in
    each float32 run, and their weight over the mean weight."""
    import torch
    from realtime_yukarin_tpu_torch.training import losses
    for fft in (512, 1024, 2048):
        def spectrum(w):
            T = w.shape[-1]
            idx = (torch.arange((T - fft) // (fft // 4) + 1)[:, None]
                   * (fft // 4) + torch.arange(fft))
            frames = w.cpu().double()[..., idx] * losses.hann(
                fft, like=w.cpu().double())
            return torch.fft.rfft(frames, dim=-1)
        x64 = spectrum(wave64)
        mag = x64.abs()
        weight = 1.0 / (mag + 1e-6)
        xs = {k: spectrum(w) for k, w in waves.items()}
        for i in torch.argsort(mag.flatten())[:n]:
            at = tuple(int(j) for j in torch.unravel_index(i, mag.shape))
            line = (f"[wave-grad] STFT {fft} bin {at}: f64 |X| "
                    f"{float(mag[at]):.3e}, Re X {float(x64[at].real):+.3e}")
            for k, x in xs.items():
                line += f" | {k} Re X {float(x[at].real):+.3e}"
            print(line + f" | weight {float(weight[at] / weight.mean()):.0f}"
                  f"x the mean")


def main() -> int:
    import torch

    import chip_smoke
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.dsp import synthesis
    from realtime_yukarin_tpu_torch.models.voice_changer import (
        params_trainable)
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
    from realtime_yukarin_tpu_torch.training import train_step as ts
    from realtime_yukarin_tpu_torch.training.data import make_batch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = Config()
    batch = make_batch(cfg, args.batch, seconds=chip_smoke.TRAIN_FRAMES
                       * cfg.dsp.hop / cfg.dsp.sample_rate,
                       seed=chip_smoke.SEED + 11, device="cpu")
    params = chip_smoke.perturbed_training_params(cfg)
    net32 = params_trainable(params, "cpu")["vocoder_wave"]
    net64 = copy.deepcopy(net32).double()
    batch64 = dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)})
    with mock.patch.object(synthesis, "harmonic_bank",
                           hb.harmonic_bank_plain):
        g64, wave64 = wave_term_grads(net64, batch64, cfg, torch.float64)
    c64 = g64["(cotangent)"]
    g32, wave32 = wave_term_grads(net32, batch, cfg, torch.float32, c64)
    runs, waves = {"cpu f32": g32}, {"cpu f32": wave32}
    if args.device == "cuda":
        net_d = params_trainable(params, "cuda")["vocoder_wave"]
        runs["cuda f32"], waves["cuda f32"] = wave_term_grads(
            net_d, batch.to("cuda"), cfg, torch.float32, c64)
        print(torch.cuda.get_device_name(0))
    # the training step's own gradient of the wave decoder is this term's
    for label, dev in (("cpu", "cpu"), ("cuda", args.device)):
        if dev != label:
            continue
        p = params_trainable(params, dev)
        _, g = ts.loss_and_grads(p, batch.to(dev), cfg)
        names = [n for n, _ in p["vocoder_wave"].named_parameters()]
        rel, cos = compare(torch.cat([x.flatten() for x in g[
            "vocoder_wave"]]), torch.cat([runs[f"{label} f32"][n].flatten()
                                          for n in names]))
        print(f"[wave-grad] {label}: loss_and_grads' vocoder_wave gradient "
              f"vs this term's: {rel:.3e} (cos {cos:.6f})")
    track = synthesis.integrate_phase(
        *synthesis.synthesis_controls(batch.f0_voc, batch.env_voc,
                                      batch.ap_voc, cfg.dsp)[2:],
        cfg.dsp, synthesis.SynthCarry.zeros(cfg.dsp, "cpu", torch.float32,
                                            (args.batch,)))
    print(f"[wave-grad] default Config, batch {args.batch} x "
          f"{chip_smoke.TRAIN_FRAMES} frames; max unwrapped advance "
          f"{float(track.adv.abs().max()):.1f} rad; frac_ratios "
          f"{net32.frac_ratios.detach().tolist()}")
    for name in g64:
        line = (f"[wave-grad] {name} {tuple(g64[name].shape)}: f64 peak "
                f"{float(g64[name].abs().max()):.3e}")
        for label, g in runs.items():
            rel, cos = compare(g[name], g64[name])
            line += f" | {label} vs f64 {rel:.3e} (cos {cos:.6f})"
        if "cuda f32" in runs:
            rel, cos = compare(runs["cuda f32"][name], g32[name])
            line += f" | cuda vs cpu f32 {rel:.3e} (cos {cos:.6f})"
        print(line)
    # the render's Jacobian alone: every run's J^T c64 against float64's
    for name in g64:
        if name == "(cotangent)":
            continue
        line = f"[wave-grad] {name} at the f64 cotangent:"
        for label, g in runs.items():
            rel, cos = compare(g[f"{name} at c64"], g64[name])
            line += f" | {label} vs f64 {rel:.3e} (cos {cos:.6f})"
        print(line)
    whole = {k: torch.cat([g.detach().cpu().double().flatten()
                           for n, g in v.items() if n in g64
                           and n != "(cotangent)"])
             for k, v in
             dict(runs, **{"f64": g64}).items()}
    for label in runs:
        rel, cos = compare(whole[label], whole["f64"])
        print(f"[wave-grad] whole subtree {label} vs f64: {rel:.3e} (cos "
              f"{cos:.6f})")
    smallest_bins(wave64, waves)
    return 0


if __name__ == "__main__":
    sys.exit(main())
