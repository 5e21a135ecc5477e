"""Corpus training: ``cli.train``'s loop body, ``CorpusDataset.sample_batch``
then the captured joint step (``make_train_step``).

Set-up writes the corpus (``corpus.formant_pairs``: seeded formant pairs
as 16-bit WAVs) under the run's temporary directory, prepares it with the
program's ``prepare_corpus`` (what ``cli.prepare`` runs), builds the
dataset and one training state from the seed's weights, and drives that
state through its first ``checked_steps`` steps with the window's own call
and feed (the first one captures the step); the losses, the first step's
gradient as AdamW holds it and the parameters after the last are read
before the window goes on with the same objects.

Reported: ``train_frames_per_s`` (batch x crop frames stepped over the
window's wall seconds, batch sampling included).  The check: the
reference prepares the drawn pairs itself from the same WAVs, draws the
same crops and runs the same steps from the same weights
(``reference/training.py``); compared are each step's loss, the first
gradient's norm and the parameters' change, leaf by leaf.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import cellkit, corpus, formulas, harness
from benchmark.reference import training as ref_training

BETA1 = 0.9             # AdamW's first moment: exp_avg = (1 - b1) g


def setup(ctx) -> dict:
    from realtime_yukarin_tpu_torch.training.corpus import prepare_corpus
    from realtime_yukarin_tpu_torch.training.dataset import CorpusDataset
    from realtime_yukarin_tpu_torch.training.train_step import (
        init_train_state, make_train_step)
    ctx.phase("program imported")
    tr, dev = ctx.cell.traffic, ctx.device
    cfg = cellkit.program_config(ctx.cell)
    ref_cfg = cellkit.reference_config(ctx.cell)
    weights = cellkit.make_weights(ctx)
    ctx.phase("weights")
    tmp = tempfile.TemporaryDirectory(prefix="bench-corpus-")
    root = pathlib.Path(tmp.name)
    pairs = corpus.formant_pairs(root, tr["corpus"], ref_cfg.dsp.sample_rate,
                                 ctx.rng_seed(5))
    ctx.phase("corpus written")
    prepare_corpus(str(root / "src"), str(root / "tgt"), str(root / "prep"),
                   cfg, bucket_frames=int(tr["bucket_frames"]),
                   verbose=False, device=dev)
    ctx.phase("corpus prepared")
    ds_seed = int(np.random.SeedSequence(ctx.rng_seed(6)).generate_state(1)[0])
    ds = CorpusDataset(str(root / "prep"), cfg,
                       crop_frames=int(tr["crop_frames"]), seed=ds_seed,
                       device=dev)
    state = init_train_state(cellkit.program_params(weights, cfg), dev)
    step = make_train_step(cfg)
    B = int(tr["batch_size"])
    losses, grads1 = [], None
    for k in range(int(tr["checked_steps"])):
        state, metrics = step(state, ds.sample_batch(B))
        losses.append(metrics["loss"].clone())
        if k == 0:
            grads1 = _first_moments(state)
    after = _named_params(state.params, clone=True)
    ctx.phase("first steps")
    ctx.tracer.start()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    F = int(tr["crop_frames"])
    ctx.tracer.info.update(
        frames_per_step=B * F,
        learned_flops_step=3 * formulas.train_forward_flops(ref_cfg, B, F),
        bank_bwd_least_s=tr["renders_per_step"] * formulas.least_s(
            *formulas.bank_backward_cost(B * F, ref_cfg.dsp.num_harmonics,
                                         ref_cfg.dsp.hop, phase=False)))
    return dict(tmp=tmp, pairs=pairs, weights=weights, ds=ds, state=state,
                step=step, B=B, F=F, ds_seed=ds_seed,
                losses=[float(v) for v in losses], grads1=grads1,
                after=after)


def _named_params(params: dict, clone: bool = False) -> dict:
    """{subtree/name: tensor} of every trainable leaf."""
    out = {}
    for k, v in params.items():
        items = (v.named_parameters() if isinstance(v, torch.nn.Module)
                 else v.items())
        for n, t in items:
            out[f"{k}/{n}"] = t.detach().clone() if clone else t
    return out


def _first_moments(state) -> dict:
    """The gradient AdamW got at its first step, by leaf: exp_avg / (1 -
    b1) (zeros for a leaf it holds no moment of)."""
    out = {}
    for name, p in _named_params(state.params).items():
        m = state.opt.state.get(p, {}).get("exp_avg")
        out[name] = (torch.zeros_like(p.detach()) if m is None
                     else m.detach() / (1.0 - BETA1))
    return out


def window(ctx, st) -> harness.Window:
    ds, step, B, tracer = st["ds"], st["step"], st["B"], ctx.tracer
    state = st["state"]
    dev = ctx.device
    steps, at = 0, []
    t_start = time.perf_counter()
    elapsed = 0.0
    while elapsed < ctx.seconds:
        tracer.begin(elapsed / ctx.seconds)
        with tracer.span("host.step"):
            with tracer.span("host.sample_batch"):
                batch = ds.sample_batch(B)
            with tracer.span("host.train_step"):
                state, _ = step(state, batch)
        tracer.end()
        steps += 1
        elapsed = time.perf_counter() - t_start
        at.append(elapsed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    records = tracer.finish() if ctx.trace else None
    frames = steps * B * st["F"]
    print(f"[train] {steps} steps in {wall:.3f} s ({1e3 * wall / steps:.3f}"
          f" ms a step); step ms by 5 s: "
          f"{cellkit.by_segment(at[1:], 1e3 * np.diff(at))}", file=sys.stderr)
    return harness.Window(attempted=steps, failed=0,
                          metrics={"train_frames_per_s": frames / wall},
                          records=records)


def _leaf_gaps(prog: dict, ref: dict, names) -> tuple[float, float]:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of the
    reference's norm of that leaf and of its median leaf: (the worst leaf's,
    the median leaf's)."""
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = float(np.median(list(rn.values())))
    gaps = [abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names]
    return max(gaps), float(np.median(gaps))


def reference_readings(ctx, st, control: bool = False) -> dict:
    """The reference's steps from the seed's weights over the same draws,
    float32 (the control: with TF32): {losses, grads1 (by leaf), after (by
    leaf)}."""
    tr, dev = ctx.cell.traffic, ctx.device
    ref_cfg = cellkit.reference_config(ctx.cell, control)
    params = cellkit.reference_params(st["weights"], ref_cfg, dev)
    for v in params.values():
        if isinstance(v, torch.nn.Module):
            v.train().requires_grad_(True)
        else:
            for t in v.values():
                t.requires_grad_(True)
    opt = ref_training.optimizer(params)
    sampler = ref_training.Sampler(st["pairs"], ref_cfg, st["F"],
                                   st["ds_seed"], int(tr["bucket_frames"]),
                                   dev)
    losses, grads1 = [], None
    with cellkit.control_precision(control):
        for k in range(int(tr["checked_steps"])):
            out = ref_training.train_step(params, opt,
                                          sampler.batch(st["B"]), ref_cfg)
            losses.append(out.loss)
            if k == 0:
                grads1 = _by_name(params, out.grads)
    return dict(losses=losses, grads1=grads1,
                after=_named_params(params, clone=True))


def _by_name(params: dict, grads: dict) -> dict:
    out = {}
    for k, v in params.items():
        names = ([n for n, _ in v.named_parameters()]
                 if isinstance(v, torch.nn.Module)
                 else list(ref_training.F0_STAT_NAMES))
        for n, g in zip(names, grads[k]):
            out[f"{k}/{n}"] = g
    return out


def numbers(st, ref: dict, prog: dict) -> dict:
    """loss_gap: the worst step's |loss - ref| / |ref|; grad_gap_* and
    change_gap_*: the worst and the median leaf's gap of norms
    (:func:`_leaf_gaps`) of the first gradient and of the parameters'
    change, the latter over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (a leaf with none moves by
    round-off under Adam)."""
    names = sorted(ref["grads1"])
    before = {f"{k}/{n}": t for k, sd in st["weights"].items()
              if k != "f0_stats" for n, t in sd.items()}
    before.update({f"f0_stats/{n}": t
                   for n, t in st["weights"]["f0_stats"].items()})
    gn = {n: float(torch.linalg.vector_norm(ref["grads1"][n].double()))
          for n in names}
    med = float(np.median(list(gn.values())))
    moved = [n for n in names if gn[n] >= 1e-3 * med]
    d_prog = {n: prog["after"][n] - before[n] for n in moved}
    d_ref = {n: ref["after"][n] - before[n] for n in moved}
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_max, g_med = _leaf_gaps(prog["grads1"], ref["grads1"], names)
    c_max, c_med = _leaf_gaps(d_prog, d_ref, moved)
    return {"loss_gap": loss_gap, "grad_gap_max": g_max,
            "grad_gap_median": g_med, "change_gap_max": c_max,
            "change_gap_median": c_med}


def check(ctx, st, win, control: bool = False) -> dict:
    dev = ctx.device
    prog = dict(losses=st["losses"], grads1=st["grads1"], after=st["after"])
    for k in ("state", "step", "ds"):
        del st[k]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, st)
    out = numbers(st, ref, prog)
    print(f"[train] reference: {len(prog['losses'])} steps in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    if control:
        ctl = reference_readings(ctx, st, control=True)
        out.update({f"control_{k}": v
                    for k, v in numbers(st, ref, ctl).items()})
    st["tmp"].cleanup()
    return out
