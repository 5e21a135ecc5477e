"""Batched serving, closed loop: ``BatchedServer.step(chunks, live,
reset)`` with host arrays, as the socket server's ticker calls it at
``realtime_factor`` 0 (the next tick starts when the last one's audio is
back on the host).

Traffic (``traffic/<mix>.json``): ``lanes`` lanes under :mod:`churn`'s
join and pause schedule, each caller reading a signal of a pool made at
set-up (:mod:`signals`), every tick's chunks gathered out of it at once.

Reported: ``xrealtime`` (live lanes' audio seconds over the window's wall
seconds), ``chunk_ms_p95`` (over every live chunk: tick start, when its
chunk is due, to its converted audio on the host).  The check: lanes drawn
from the seed among those whose last caller joined within the output ring
(the one with the longest history among them, and one that resumed after a
pause, always), stepped by the reference from that join over the same
chunks and pauses, every tick's output compared (``cellkit.gaps``).
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from benchmark import cellkit, formulas, harness
from benchmark.churn import Churn
from benchmark.reference import lanes as ref_lanes
from benchmark.reference.streaming.pipeline import lane_noise_keys
from benchmark.reference.streaming.state import StreamGeometry
from benchmark.signals import speech_pool


def setup(ctx) -> dict:
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    ctx.phase("program imported")
    tr, dev = ctx.cell.traffic, ctx.device
    cfg = cellkit.program_config(ctx.cell)
    ref_cfg = cellkit.reference_config(ctx.cell)
    geo = StreamGeometry.from_config(ref_cfg, True, vocoder_mode="dsp")
    fs = ref_cfg.dsp.in_rate
    S = geo.chunk_in_samples
    weights = cellkit.make_weights(ctx)
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
    server = BatchedServer(cellkit.program_params(weights, cfg), cfg,
                           num_streams=N, seed=ctx.seed % 2 ** 32,
                           device=dev)
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
    rows = N * geo.chunk_frames
    ctx.tracer.info.update(
        lanes=N, rows=rows, chunk_s=chunk_s,
        learned_flops_lane=formulas.serve_learned_flops(ref_cfg, geo),
        analysis_least_s=formulas.analysis_least_s(ref_cfg, rows),
        bank_least_s=formulas.least_s(*formulas.bank_forward_cost(
            rows, ref_cfg.dsp.num_harmonics, ref_cfg.dsp.hop)))
    return dict(server=server, weights=weights, pool=pool, windows=windows,
                L=L, S=S, chunk_s=chunk_s, geo=geo,
                churn=Churn(tr, chunk_s, S, L, len(pool),
                            ctx.rng_seed(3)))


def window(ctx, st) -> harness.Window:
    server, windows, churn = st["server"], st["windows"], st["churn"]
    tracer = ctx.tracer
    # the last ticks' outputs, as the program returned them
    ring = collections.deque(maxlen=max(1, round(
        ctx.cell.traffic["check"]["ring_s"] / st["chunk_s"])))
    lat, live_n, sched, at = [], [], [], []
    t_start = time.perf_counter()
    elapsed = 0.0
    while elapsed < ctx.seconds:
        tracer.begin(elapsed / ctx.seconds)
        with tracer.span("host.step"):
            t_due = time.perf_counter()
            with tracer.span("host.gather"):
                live, reset, sig, pos = churn.tick()
                chunks = windows[sig, pos]
            with tracer.span("host.server_step"):
                out = server.step(chunks, live, reset)
            t_done = time.perf_counter()
            with tracer.span("host.scatter"):
                ring.append(out)
                n = int(live.sum())
                lat.append(t_done - t_due)
                at.append(t_due - t_start)
                live_n.append(n)
                sched.append((live, reset, sig, pos))
        tracer.count("lane_steps_live", n)
        tracer.end()
        elapsed = time.perf_counter() - t_start
    wall = elapsed
    live_ticks = int(np.sum(live_n))
    metrics = {
        "xrealtime": live_ticks * st["chunk_s"] / wall,
        "chunk_ms_p95": 1e3 * cellkit.weighted_quantile(lat, live_n, 0.95)}
    records = tracer.finish() if ctx.trace else None
    print(f"[serve] {len(lat)} ticks in {wall:.3f} s, {live_ticks} live "
          f"chunks; tick p50 {1e3 * np.median(lat):.3f} ms; by 5 s: "
          f"{cellkit.by_segment(at, 1e3 * np.asarray(lat))} ms",
          file=sys.stderr)
    return harness.Window(attempted=live_ticks, failed=0, metrics=metrics,
                          records=records,
                          data=dict(ring=ring, sched=sched))


def _check_lanes(ctx, sched, ring_len: int) -> tuple[np.ndarray, np.ndarray]:
    """(lanes, their last join tick) drawn from the seed among lanes whose
    last caller joined within the ring; the longest history always in, and
    one lane that resumed after a pause always in, where the mix
    pauses lanes."""
    T = len(sched)
    reset = np.stack([s[1] for s in sched])               # [T, N]
    joined = np.where(reset.any(0), T - 1 - np.argmax(reset[::-1], 0), -1)
    cand = np.flatnonzero(joined >= T - ring_len)
    if len(cand) == 0:
        raise harness.RunError("no lane joined within the check's ring")
    paused = ~np.stack([s[0] for s in sched])
    paused &= np.arange(T)[:, None] > joined[None]
    # a pause followed by a live tick, so that the live mask is compared
    resumed = cand[(paused[:-1] & ~paused[1:])[:, cand].any(0)]
    k = int(ctx.cell.traffic["check"]["lanes"])
    rng = np.random.default_rng(ctx.rng_seed(4))
    first = cand[np.argmin(joined[cand])]
    rest = rng.permutation(cand[cand != first])[: k - 1]
    pick = np.concatenate([[first], rest]).astype(np.int64)
    if len(resumed) and not np.isin(pick, resumed).any():
        pick[-1] = rng.choice(resumed[resumed != first])
    return pick, joined[pick]


def check(ctx, st, win, control: bool = False) -> dict:
    ring, sched = win.data["ring"], win.data["sched"]
    T, windows, dev = len(sched), st["windows"], ctx.device
    lanes, start = _check_lanes(ctx, sched, len(ring))
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
    # the chunks of the first event_s seconds after a join or a resume
    event_chunks = max(1, round(ctx.cell.traffic["check"]["event_s"]
                                / st["chunk_s"]))

    chunks = windows[sig, pos]                           # [T, K, S]
    def run(control_side: bool):
        ref_cfg = cellkit.reference_config(ctx.cell, control_side)
        params = cellkit.reference_params(weights, ref_cfg, dev)
        with cellkit.control_precision(control_side):
            return ref_lanes.replay(params, ref_cfg, keys, chunks, live,
                                    dev)

    t_ref = time.perf_counter()
    ref = run(False)
    numbers = cellkit.gaps(prog, ref, advanced, start, event_chunks)
    print(f"[serve] reference: {len(lanes)} lanes over {T - t0} ticks in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    if control:
        numbers.update({f"control_{k}": v for k, v in cellkit.gaps(
            run(True), ref, advanced, start, event_chunks).items()})
    return numbers
