"""Training CLI of the PyTorch port (port of ``cli/train.py``), one device.

Trains all model stages jointly (stage-1 mc regression, stage-2 envelope
super-resolution, both neural vocoders' multi-resolution STFT through the
differentiable renderer), optionally with the adversarial stage-2
objective (--gan), on the self-generated speaker pairs of
``training/data.py`` (``--synthetic``).  Runs on ``cuda`` unless
``--device cpu`` is given.

Usage:
    python -m realtime_yukarin_tpu_torch.cli.train --synthetic --steps 50 \\
        [--gan] [--ckpt_dir ckpts/] [--export_params params.npz]

``--export_params`` writes the JAX package's ``.npz`` layout (the EMA
generator under --gan), which ``realtime_yukarin_tpu``'s ``load_params``
and this port's ``load_params_npz`` both read.  The corpus path, the
vocoder fine-tune and multi-GPU / multi-host training are not ported yet;
their flags are refused (with the ROADMAP.md item that brings each).
"""

from __future__ import annotations

import argparse
import time

import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.discriminator import init_discriminator
from realtime_yukarin_tpu_torch.models.voice_changer import (init_params,
                                                             save_params_npz)
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.checkpoint import (
    restore_checkpoint, save_checkpoint)
from realtime_yukarin_tpu_torch.training.data import make_batch
from realtime_yukarin_tpu_torch.training.train_step import (
    init_gan_train_state, init_train_state, make_gan_train_step,
    make_train_step)

_CORPUS = "ROADMAP.md queue 1 item 10 (the corpus training path)"
_MULTI = "ROADMAP.md queue 1 item 11 (multi-GPU and multi-host)"
# flag -> (value that means "not used", the ROADMAP item that brings it)
UNSUPPORTED = {
    "prepared_dir": (None, _CORPUS),
    "cache_utterances": (None, _CORPUS),
    "finetune_converted": (0, _CORPUS),
    "model_parallel": (1, _MULTI),
    "coordinator_address": (None, _MULTI),
    "num_processes": (None, _MULTI),
    "process_id": (None, _MULTI),
}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse, then refuse at once what this port does not run."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--synthetic", action="store_true",
                   help="self-generated speaker pairs (required)")
    p.add_argument("--prepared_dir", default=None,
                   help="not ported: " + _CORPUS)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--export_params", default=None,
                   help="write the final inference params here (.npz)")
    p.add_argument("--config_path", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop_frames", type=int, default=100)
    p.add_argument("--cache_utterances", type=int, default=None,
                   help="not ported: " + _CORPUS)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gan", action="store_true",
                   help="adversarial stage-2 objective")
    p.add_argument("--adv_weight", type=float, default=0.02)
    p.add_argument("--finetune_converted", type=int, default=0,
                   metavar="STEPS", help="not ported: " + _CORPUS)
    p.add_argument("--ckpt_every", type=int, default=200)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="not ported: " + _MULTI)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator_address", default=None,
                   help="not ported: " + _MULTI)
    p.add_argument("--num_processes", type=int, default=None,
                   help="not ported: " + _MULTI)
    p.add_argument("--process_id", type=int, default=None,
                   help="not ported: " + _MULTI)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback)")
    args = p.parse_args(argv)
    for flag, (unused, item) in UNSUPPORTED.items():
        if getattr(args, flag) != unused:
            p.error(f"--{flag} is not ported yet: {item}")
    if not args.synthetic:
        p.error("need --synthetic (the corpus path is not ported yet: "
                f"{_CORPUS})")
    if args.export_params and not args.export_params.endswith(".npz"):
        p.error("--export_params must name a .npz file")
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config_path) if args.config_path else Config()
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed))
    if args.gan:
        disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                                  torch.Generator().manual_seed(cfg.seed + 1))
        state = init_gan_train_state(params, disc, device, args.lr)
        step_fn = make_gan_train_step(cfg, args.adv_weight)
    else:
        state = init_train_state(params, device, args.lr)
        step_fn = make_train_step(cfg)

    start_step = 0
    if args.ckpt_dir:
        state, start_step = restore_checkpoint(args.ckpt_dir, state)
        if start_step:
            print(f"[train] resumed from step {start_step}")

    seconds = args.crop_frames * cfg.dsp.hop / cfg.dsp.sample_rate
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = make_batch(cfg, args.batch_size, seconds=seconds,
                           seed=args.seed + step, device=device)
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (step + 1 - start_step) / (time.perf_counter() - t0)
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
            print(f"[train] step {step + 1}/{args.steps} {msg} "
                  f"({rate:.2f} it/s on {device})")
        if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                              or step + 1 == args.steps):
            path = save_checkpoint(args.ckpt_dir, state, step + 1)
            print(f"[train] checkpoint -> {path}")

    if args.export_params:
        # --gan: the inference tree is the EMA generator
        save_params_npz(state.ema_params if args.gan else state.params,
                        args.export_params)
        print(f"[train] inference params -> {args.export_params}")


if __name__ == "__main__":
    main()
