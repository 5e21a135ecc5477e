"""Batched serving, closed loop, in the bigvgan vocoder mode: ``serve.py``'s
loop, churn and check (the window is ``serve.window``, the drawn lanes
``serve._check_lanes``, as ``serve_vocoder.py`` takes them), with the
BigVGAN v2 generator's own weights, reference, geometry and FLOP count.

The configuration's ``vocoder_bigvgan`` section (the generator's layer
list, the program's alone) is split off for the reference's ``Config``
(``reference/streaming/bigvgan.py:split_config``).  The generator's
weights follow ``weights.py``'s rule, drawn from their own stream of the
seed in one call: lecun-normal kernels (variance 1 / ``w[0].numel()``),
each AMP block's second convolutions (the last of each residual branch)
at ``residual_scale`` of that, so that the residual stream stays near the
transposed convolution's scale through the stage, as a trained
generator's does (at 1 the seeded generator's activations grow about
tenfold over the six stages), biases at ``bias_scale`` times a unit
normal, and each activation's log alpha and log beta at
``snake_log_spread`` times a unit normal (so alpha and beta spread over a
few times either way of 1, and the snake's period varies across
channels).

Traced, the cell's info adds ``bigvgan_least_s`` and
``bigvgan_act_least_s``: the generator's and its activations' least time
a tick over every lane and the cone's rows
(``formulas_bigvgan.generator_least_s`` / ``act_least_s``), which
``metrics/bigvgan_roofline.serve.py`` and
``metrics/bigvgan_act_roofline.serve.py`` read.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import cellkit, formulas, formulas_bigvgan
from benchmark import weights as bench_weights
from benchmark.churn import Churn
from benchmark.drivers import serve
from benchmark.formulas_hifigan import vocoder_input_dim
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.models.vocoder_bigvgan import Generator
from benchmark.reference.models.voice_changer import stage_nets as ref_nets
from benchmark.reference.streaming import bigvgan as ref_bigvgan
from benchmark.signals import speech_pool

BIGVGAN = "vocoder_bigvgan"
window = serve.window


def reference_config(cell, control: bool = False):
    """(the reference's Config, the generator's layer list): float32, or
    the control's precision (``cellkit.CONTROL_DTYPE``)."""
    d, b = ref_bigvgan.split_config(cell.config["config"])
    return RefConfig.from_dict({**d, "compute_dtype": (
        cellkit.CONTROL_DTYPE if control else "float32")}), b


def generator_weights(ref_cfg, b, spec: dict, seed: int, device) -> dict:
    """The generator's state dict by the module docstring's rule, in one
    draw on ``device``: each conv's kernel then bias, in module order,
    then each activation's alpha and beta."""
    net = Generator(b, vocoder_input_dim(ref_cfg))
    shapes = []
    for name, layer in net.layers().items():
        w = layer.weight
        scale = 1.0 / math.sqrt(w[0].numel())
        if ".convs2." in name:
            scale *= spec["residual_scale"]
        shapes.append((f"{name}.weight", tuple(w.shape), scale))
        if layer.bias is not None:
            shapes.append((f"{name}.bias", tuple(layer.bias.shape),
                           spec["bias_scale"]))
    for name, snake in net.snakes().items():
        for p in ("alpha", "beta"):
            shapes.append((f"{name}.{p}", tuple(getattr(snake, p).shape),
                           spec["snake_log_spread"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes),
                       generator=gen, device=device)
    out, i = {}, 0
    for key, shape, scale in shapes:
        n = math.prod(shape)
        out[key] = flat[i: i + n].view(shape) * scale
        i += n
    return out


def make_weights(ctx, ref_cfg, b) -> dict:
    """The cell's weights: ``weights.make_weights``' for every stage, and
    the generator's."""
    spec = ctx.cell.config["weights"]
    w = bench_weights.make_weights(ref_cfg, spec, ctx.torch_seed(1),
                                   ctx.device)
    w[BIGVGAN] = generator_weights(ref_cfg, b, spec, ctx.torch_seed(5),
                                   ctx.device)
    return w


def program_params(weights: dict, cfg) -> dict:
    from realtime_yukarin_tpu_torch.models.vocoder_bigvgan import \
        BigVGANGenerator
    params = cellkit.program_params(weights, cfg)
    net = BigVGANGenerator(cfg.vocoder_bigvgan, cfg.dsp)
    net.load_state_dict({k: t.clone() for k, t in weights[BIGVGAN].items()},
                        assign=True)
    params[BIGVGAN] = net
    return params


def reference_params(weights: dict, ref_cfg, b, device) -> dict:
    params = bench_weights.load_into(ref_nets(ref_cfg), weights)
    net = Generator(b, vocoder_input_dim(ref_cfg))
    net.load_state_dict({k: t.clone() for k, t in weights[BIGVGAN].items()},
                        assign=True)
    params[BIGVGAN] = net
    for v in params.values():
        if isinstance(v, torch.nn.Module):
            v.to(device).eval().requires_grad_(False)
    return params


def setup(ctx) -> dict:
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    ctx.phase("program imported")
    tr, dev = ctx.cell.traffic, ctx.device
    cfg = cellkit.program_config(ctx.cell)
    ref_cfg, b = reference_config(ctx.cell)
    geo = ref_bigvgan.geometry(ref_cfg, b)
    fs = ref_cfg.dsp.in_rate
    S = geo.chunk_in_samples
    weights = make_weights(ctx, ref_cfg, b)
    ctx.phase("weights")
    pool_spec = tr["pool"]
    pool = speech_pool(pool_spec["signals"], pool_spec["seconds"], fs,
                       ctx.torch_seed(2), dev, pool_spec["f0_scale"],
                       pool_spec["gain"])
    L = pool.shape[1]
    pool = np.concatenate([pool, pool[:, :S]], axis=1)   # positions wrap
    windows = np.lib.stride_tricks.sliding_window_view(pool, S, axis=1)
    ctx.phase("signals")
    N = int(tr["lanes"])
    server = BatchedServer(program_params(weights, cfg), cfg,
                           num_streams=N, seed=ctx.seed % 2 ** 32,
                           vocoder_mode="bigvgan", device=dev)
    ctx.phase("program")
    warm = windows[np.arange(N) % len(pool), (np.arange(N) * 997) % L]
    for _ in range(int(tr["warmup_steps"])):
        server.step(warm)
    ctx.phase("warm-up")
    ctx.tracer.start()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    chunk_s = S / fs
    Fc = geo.chunk_frames
    rows = N * Fc
    halo = ref_bigvgan.halo_frames(b)
    shape = (b, vocoder_input_dim(ref_cfg), N, Fc + 1 + 2 * halo, halo,
             ref_cfg.dsp.hop)
    ctx.tracer.info.update(
        lanes=N, rows=rows, chunk_s=chunk_s, vocoder_mode="bigvgan",
        learned_flops_lane=formulas_bigvgan.serve_learned_flops(
            ref_cfg, geo, b, halo),
        analysis_least_s=formulas.analysis_least_s(ref_cfg, rows),
        bigvgan_least_s=formulas_bigvgan.generator_least_s(*shape),
        bigvgan_act_least_s=formulas_bigvgan.act_least_s(*shape))
    return dict(server=server, weights=weights, pool=pool, windows=windows,
                L=L, S=S, chunk_s=chunk_s, geo=geo,
                churn=Churn(tr, chunk_s, S, L, len(pool),
                            ctx.rng_seed(3)))


def check(ctx, st, win, control: bool = False) -> dict:
    """``serve.check`` in the bigvgan mode: the drawn lanes replayed by the
    reference from their joins over the same chunks and pauses."""
    ring, sched = win.data["ring"], win.data["sched"]
    T, windows, dev = len(sched), st["windows"], ctx.device
    lanes, start = serve._check_lanes(ctx, sched, len(ring))
    t0 = int(start.min())
    prog = np.stack([ring[t - (T - len(ring))][lanes] for t in range(t0, T)])
    weights = st["weights"]
    del st["server"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    advanced = np.stack([sched[t][0][lanes] for t in range(t0, T)])
    start = start - t0
    live = advanced & (np.arange(T - t0)[:, None] >= start[None])
    sig = np.stack([sched[t][2][lanes] for t in range(t0, T)])
    pos = np.stack([sched[t][3][lanes] for t in range(t0, T)])
    event_chunks = max(1, round(ctx.cell.traffic["check"]["event_s"]
                                / st["chunk_s"]))
    chunks = windows[sig, pos]                           # [T, K, S]

    def run(control_side: bool):
        ref_cfg, b = reference_config(ctx.cell, control_side)
        params = reference_params(weights, ref_cfg, b, dev)
        with cellkit.control_precision(control_side):
            return ref_bigvgan.replay(params, ref_cfg, b, chunks, live, dev)

    t_ref = time.perf_counter()
    ref = run(False)
    numbers = cellkit.gaps(prog, ref, advanced, start, event_chunks)
    level = float(np.sqrt(np.mean(ref[live] ** 2)))
    print(f"[serve_bigvgan] reference: {len(lanes)} lanes over {T - t0} "
          f"ticks in {time.perf_counter() - t_ref:.1f} s; output RMS "
          f"{level:.4g}, |y| > 0.99 in "
          f"{float(np.mean(np.abs(ref[live]) > 0.99)):.3g} of samples",
          file=sys.stderr)
    if control:
        numbers.update({f"control_{k}": v for k, v in cellkit.gaps(
            run(True), ref, advanced, start, event_chunks).items()})
    return numbers
