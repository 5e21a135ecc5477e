"""Batched serving, closed loop, in the configuration's vocoder mode:
``serve.py``'s loop, churn and check, with the server, the geometry, the
weights, the learned FLOPs and the reference's replay in the mode that
``config.vocoder_mode`` names (``dsp``, ``ddsp``, ``wave`` or
``hifigan``), so a cell of any mode is a configuration file and a traffic
mix.

The configuration's ``vocoder_hifigan`` section (the HiFi-GAN V1
generator's layer list, the program's alone) is split off for the
reference's ``Config`` (``reference/streaming/hifigan.py:split_config``);
the generator's weights follow ``weights.py``'s rule, drawn from their own
stream of the seed: lecun-normal kernels (variance 1 / ``w[0].numel()``,
as there) and biases at ``bias_scale`` times a unit normal; the generator
has no zero-initialised head, so no layer takes ``head_scale``.

Traced, the cell's info adds ``vocoder_least_s``: the generator's least
time a tick over every lane (``formulas_hifigan.generator_least_s``), which
``metrics/vocoder_roofline.serve.py`` reads.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import cellkit, formulas, formulas_hifigan
from benchmark import weights as bench_weights
from benchmark.churn import Churn
from benchmark.drivers import serve
from benchmark.reference import lanes as ref_lanes
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.models.vocoder_hifigan import Generator
from benchmark.reference.models.voice_changer import stage_nets as ref_nets
from benchmark.reference.streaming import hifigan as ref_hifigan
from benchmark.reference.streaming.pipeline import lane_noise_keys
from benchmark.reference.streaming.state import StreamGeometry
from benchmark.signals import speech_pool

HIFIGAN = "vocoder_hifigan"
window = serve.window


def reference_config(cell, control: bool = False):
    """(the reference's Config, the generator's layer list): float32, or
    the control's precision (``cellkit.CONTROL_DTYPE``)."""
    d, h = ref_hifigan.split_config(cell.config["config"])
    return RefConfig.from_dict({**d, "compute_dtype": (
        cellkit.CONTROL_DTYPE if control else "float32")}), h


def geometry(ref_cfg, h, mode: str) -> StreamGeometry:
    if mode == "hifigan":
        return ref_hifigan.geometry(ref_cfg, h)
    return StreamGeometry.from_config(ref_cfg, True, vocoder_mode=mode)


def generator_weights(ref_cfg, h, spec: dict, seed: int, device) -> dict:
    """The generator's state dict by ``weights.py``'s rule, in one draw on
    ``device``: each layer's kernel then bias, in module order."""
    net = Generator(h, formulas_hifigan.vocoder_input_dim(ref_cfg))
    shapes = []
    for name, layer in net.layers().items():
        w = layer.weight
        shapes.append((f"{name}.weight", tuple(w.shape),
                       1.0 / math.sqrt(w[0].numel())))
        shapes.append((f"{name}.bias", tuple(layer.bias.shape),
                       spec["bias_scale"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes),
                       generator=gen, device=device)
    out, i = {}, 0
    for key, shape, scale in shapes:
        n = math.prod(shape)
        out[key] = flat[i: i + n].view(shape) * scale
        i += n
    return out


def make_weights(ctx, ref_cfg, h, mode: str) -> dict:
    """The cell's weights: ``weights.make_weights``' for every stage, and
    the generator's in the hifigan mode."""
    spec = ctx.cell.config["weights"]
    w = bench_weights.make_weights(ref_cfg, spec, ctx.torch_seed(1),
                                   ctx.device)
    if mode == "hifigan":
        w[HIFIGAN] = generator_weights(ref_cfg, h, spec, ctx.torch_seed(5),
                                       ctx.device)
    return w


def program_params(weights: dict, cfg) -> dict:
    params = cellkit.program_params(weights, cfg)
    if HIFIGAN in weights:
        from realtime_yukarin_tpu_torch.models.vocoder_hifigan import \
            HiFiGANGenerator
        net = HiFiGANGenerator(cfg.vocoder_hifigan, cfg.dsp)
        net.load_state_dict({k: t.clone() for k, t in
                             weights[HIFIGAN].items()}, assign=True)
        params[HIFIGAN] = net
    return params


def reference_params(weights: dict, ref_cfg, h, device) -> dict:
    params = bench_weights.load_into(ref_nets(ref_cfg), weights)
    if HIFIGAN in weights:
        net = Generator(h, formulas_hifigan.vocoder_input_dim(ref_cfg))
        net.load_state_dict({k: t.clone() for k, t in
                             weights[HIFIGAN].items()}, assign=True)
        params[HIFIGAN] = net
    for v in params.values():
        if isinstance(v, torch.nn.Module):
            v.to(device).eval().requires_grad_(False)
    return params


def setup(ctx) -> dict:
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    ctx.phase("program imported")
    tr, dev = ctx.cell.traffic, ctx.device
    cfg = cellkit.program_config(ctx.cell)
    mode = cfg.resolved_vocoder_mode
    ref_cfg, h = reference_config(ctx.cell)
    geo = geometry(ref_cfg, h, mode)
    fs = ref_cfg.dsp.in_rate
    S = geo.chunk_in_samples
    weights = make_weights(ctx, ref_cfg, h, mode)
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
                           vocoder_mode=mode, device=dev)
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
    info = dict(
        lanes=N, rows=rows, chunk_s=chunk_s, vocoder_mode=mode,
        learned_flops_lane=formulas_hifigan.serve_learned_flops_mode(
            ref_cfg, geo, mode, h),
        analysis_least_s=formulas.analysis_least_s(ref_cfg, rows))
    if mode == "hifigan":
        info["vocoder_least_s"] = formulas_hifigan.generator_least_s(
            h, formulas_hifigan.vocoder_input_dim(ref_cfg), N,
            Fc + 1 + 2 * h.halo_frames)
    else:
        info["bank_least_s"] = formulas.least_s(*formulas.bank_forward_cost(
            rows, ref_cfg.dsp.num_harmonics, ref_cfg.dsp.hop))
    ctx.tracer.info.update(info)
    return dict(server=server, weights=weights, pool=pool, windows=windows,
                L=L, S=S, chunk_s=chunk_s, geo=geo, mode=mode,
                churn=Churn(tr, chunk_s, S, L, len(pool),
                            ctx.rng_seed(3)))


def check(ctx, st, win, control: bool = False) -> dict:
    """``serve.check`` in the cell's mode: the drawn lanes replayed by the
    reference from their joins over the same chunks and pauses."""
    ring, sched = win.data["ring"], win.data["sched"]
    T, windows, dev, mode = len(sched), st["windows"], ctx.device, st["mode"]
    lanes, start = serve._check_lanes(ctx, sched, len(ring))
    N = len(sched[0][0])
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
    keys = torch.tensor(lane_noise_keys(ctx.seed % 2 ** 32, N),
                        dtype=torch.int64)[lanes]
    event_chunks = max(1, round(ctx.cell.traffic["check"]["event_s"]
                                / st["chunk_s"]))
    chunks = windows[sig, pos]                           # [T, K, S]

    def run(control_side: bool):
        ref_cfg, h = reference_config(ctx.cell, control_side)
        params = reference_params(weights, ref_cfg, h, dev)
        with cellkit.control_precision(control_side):
            if mode == "hifigan":
                return ref_hifigan.replay(params, ref_cfg, h, chunks, live,
                                          dev)
            return ref_lanes.replay(params, ref_cfg, keys, chunks, live,
                                    dev, mode=mode)

    t_ref = time.perf_counter()
    ref = run(False)
    numbers = cellkit.gaps(prog, ref, advanced, start, event_chunks)
    level = float(np.sqrt(np.mean(ref[live] ** 2)))
    print(f"[serve_vocoder] reference ({mode}): {len(lanes)} lanes over "
          f"{T - t0} ticks in {time.perf_counter() - t_ref:.1f} s; output "
          f"RMS {level:.4g}, |y| > 0.99 in "
          f"{float(np.mean(np.abs(ref[live]) > 0.99)):.3g} of samples",
          file=sys.stderr)
    if control:
        numbers.update({f"control_{k}": v for k, v in cellkit.gaps(
            run(True), ref, advanced, start, event_chunks).items()})
    return numbers
