#!/usr/bin/env python3
"""Whether a training step of the PyTorch port gives the same gradients on
every run on the GPU, and what each way of making it so costs.

    python3 tools/torch_train_determinism.py [--steps 5]

At the default Config in float32 on one make_batch of 8 x 100 frames and
chip_smoke.py's perturbed weights, for the joint, GAN and fine-tune
objectives, the gradients are taken twice from the same state and
compared leaf by leaf with ``torch.equal``, under three ways of
differentiating the convolutions:

- ``port``: the port's own (``ops/conv.py``: cuDNN's forward, the backward
  written out as matmuls and ``fold``);
- ``cudnn``: cuDNN's default backward (``Fn.conv1d`` differentiated by
  autograd), what the port ran before;
- ``cudnn-deterministic``: cuDNN's backward restricted to its
  deterministic algorithms (``torch.backends.cudnn.deterministic``).

For each it prints the leaves that differ (name, largest difference, the
leaf's peak), then the eager joint step's device busy time and GPU
launches (``torch.profiler`` over ``--steps`` steps) and its peak device
memory.  Last, the ops ``torch.use_deterministic_algorithms`` flags in
warn mode during one step of each objective.  The card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import subprocess
import sys
import warnings

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

WAYS = ("port", "cudnn", "cudnn-deterministic")


@contextlib.contextmanager
def convolutions(way: str):
    """The model convolutions differentiated the ``way`` named."""
    import torch
    import torch.nn.functional as Fn

    from realtime_yukarin_tpu_torch.models import acoustic, discriminator
    if way == "port":
        yield
        return
    cudnn = torch.backends.cudnn
    users = (acoustic, discriminator)        # the modules that convolve
    saved = [m.conv1d for m in users], cudnn.deterministic
    for m in users:
        m.conv1d = lambda x, w, stride=1, padding=0: Fn.conv1d(
            x, w, stride=stride, padding=padding)
    cudnn.deterministic = way == "cudnn-deterministic"
    try:
        yield
    finally:
        for m, f in zip(users, saved[0]):
            m.conv1d = f
        cudnn.deterministic = saved[1]


def objectives(cfg, dev, batch):
    """{objective: (names of the gradient leaves, fn -> (metrics, flat
    gradients))}, each from the same weights on ``batch``."""
    import torch

    import chip_smoke
    from realtime_yukarin_tpu_torch.models.discriminator import (
        init_discriminator)
    from realtime_yukarin_tpu_torch.models.voice_changer import (
        params_trainable)
    from realtime_yukarin_tpu_torch.training import full_chain as fc
    from realtime_yukarin_tpu_torch.training import train_step as ts

    params = params_trainable(chip_smoke.perturbed_training_params(cfg), dev)
    disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                              torch.Generator().manual_seed(
                                  chip_smoke.SEED + 1)).to(dev)
    disc.requires_grad_(True)
    gan_state = ts.GanTrainState(params=params, d_params=disc, opt=None,
                                 d_opt=None, step=0, ema_params=None)

    def names(tree):
        out = []
        for k, v in tree.items():
            out += ([f"{k}.{n}" for n, _ in v.named_parameters()]
                    if isinstance(v, torch.nn.Module)
                    else [f"{k}.{n}" for n in v])
        return out

    def flat(grads):
        return [g for gs in grads.values() for g in gs]

    def joint():
        m, g = ts.loss_and_grads(params, batch, cfg)
        return m, flat(g)

    def gan():
        m, g, d = ts.gan_losses_and_grads(gan_state, batch, cfg)
        return m, flat(g) + d["params"]

    voc = {k: params[k] for k in fc.VOCODERS}
    rows = (batch.f0_voc, batch.env_voc, batch.ap_voc, batch.mc_voc,
            batch.wave_voc, batch.noise)

    def finetune():
        with ts.deterministic():
            loss = fc.finetune_loss(voc, rows, cfg)
            return {"loss": loss.detach()}, flat(ts.gradients(loss, voc))

    return {"joint": (names(params), joint),
            "gan": (names(params) + [f"disc.{n}" for n, _ in
                                     disc.named_parameters()], gan),
            "finetune": (names(voc), finetune)}


def compare(name: str, way: str, leaf_names, fn) -> None:
    import torch
    with convolutions(way):
        ma, ga = fn()
        mb, gb = fn()
    torch.cuda.synchronize()
    metrics = [k for k in ma if not torch.equal(ma[k], mb[k])]
    apart = [(n, float((a - b).abs().max()), float(a.abs().max()))
             for n, a, b in zip(leaf_names, ga, gb) if not torch.equal(a, b)]
    print(f"[determinism] {name} {way}: metrics apart {metrics}; "
          f"{len(apart)} of {len(ga)} gradient leaves apart between two "
          f"runs")
    for n, d, peak in apart:
        print(f"[determinism]   {n}: {d:.3e} of a peak {peak:.3e}")


def cost(way: str, cfg, dev, batch, steps: int) -> None:
    import functools

    import torch

    import chip_smoke
    from realtime_yukarin_tpu_torch.training import train_step as ts

    state = ts.init_train_state(chip_smoke.perturbed_training_params(cfg),
                                dev)
    body = functools.partial(ts.joint_step_body, cfg=cfg)
    with convolutions(way):
        body(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = chip_smoke.profile_stats(lambda: body(state, batch), steps)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[cost] {way}: eager joint step device busy {st['busy_ms']:.3f} "
          f"ms, {st['gpu_launches']:.1f} GPU launches per step "
          f"(torch.profiler, {steps} steps), peak allocated {peak:.0f} MiB")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5,
                    help="joint steps traced per way")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_determinism: CUDA is not available",
              file=sys.stderr)
        return 2
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.training.data import make_batch

    import chip_smoke
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.build()
    cfg, dev = Config(), torch.device("cuda")
    batch = make_batch(cfg, chip_smoke.TRAIN_BATCH,
                       seconds=chip_smoke.TRAIN_FRAMES * cfg.dsp.hop
                       / cfg.dsp.sample_rate, seed=chip_smoke.SEED,
                       device=dev)
    runs = objectives(cfg, dev, batch)
    for name, (leaf_names, fn) in runs.items():
        for way in WAYS:
            compare(name, way, leaf_names, fn)
    for way in WAYS:
        cost(way, cfg, dev, batch, args.steps)
    for name, (_, fn) in runs.items():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).split(" does not have")[0]
                          for w in seen
                          if "deterministic" in str(w.message)})
        print(f"[determinism] {name}: ops torch flags as nondeterministic "
              f"in one step: {flagged or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
