"""Training CLI of the PyTorch port (port of ``cli/train.py``), one device.

Trains all model stages jointly (stage-1 mc regression, stage-2 envelope
super-resolution, both neural vocoders' multi-resolution STFT through the
differentiable renderer), optionally with the adversarial stage-2
objective (--gan).  Data: a prepared corpus dir from ``cli.prepare``
(``--prepared_dir``, sampled by ``training/dataset.py:CorpusDataset``), or
the self-generated speaker pairs of ``training/data.py`` (``--synthetic``).
Runs on ``cuda`` unless ``--device cpu`` is given.

Usage:
    python -m realtime_yukarin_tpu_torch.cli.train --prepared_dir prepared/ \\
        [--steps 1000] [--gan] [--ckpt_dir ckpts/] \\
        [--finetune_converted STEPS] [--export_params params.npz]
    python -m realtime_yukarin_tpu_torch.cli.train --synthetic --steps 50

``--export_params`` writes the JAX package's ``.npz`` layout (the EMA
generator under --gan, the fine-tuned tree after --finetune_converted),
which ``realtime_yukarin_tpu``'s ``load_params`` and this port's
``load_params_npz`` both read.  Multi-GPU / multi-host training is not
ported yet; its flags are refused (with the ROADMAP.md item that brings
it).
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
from realtime_yukarin_tpu_torch.training.dataset import CorpusDataset
from realtime_yukarin_tpu_torch.training.train_step import (
    init_gan_train_state, init_train_state, make_gan_train_step,
    make_train_step)

_MULTI = "ROADMAP.md queue 1 item 11 (multi-GPU and multi-host)"
# flag -> value that means "not used"
UNSUPPORTED = {
    "model_parallel": 1,
    "coordinator_address": None,
    "num_processes": None,
    "process_id": None,
}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse, then refuse at once what this port does not run and any
    combination the run would refuse later."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prepared_dir", default=None,
                   help="output dir of cli.prepare")
    p.add_argument("--synthetic", action="store_true",
                   help="self-generated speaker pairs (no corpus needed)")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--export_params", default=None,
                   help="write the final inference params here (.npz)")
    p.add_argument("--config_path", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop_frames", type=int, default=100)
    p.add_argument("--cache_utterances", type=int, default=None,
                   help="bound host RAM: lazy-load corpus npz behind an "
                        "LRU of this many utterances (default: eager "
                        "full load, fine for small corpora)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gan", action="store_true",
                   help="adversarial stage-2 objective")
    p.add_argument("--adv_weight", type=float, default=0.02)
    p.add_argument("--finetune_converted", type=int, default=0,
                   metavar="STEPS",
                   help="after main training, fine-tune ONLY the two "
                        "vocoder subtrees for STEPS steps on (converted "
                        "features, real target waveform) pairs (plain "
                        "Adam at --finetune_lr, one global-norm clip). "
                        "It narrows the vocoders' train/inference "
                        "conditioning gap, but it can cost full-chain "
                        "quality: in QUALITY.json (the JAX package's CPU "
                        "recipe, 300 steps) the wave vocoder's full-chain "
                        "MCD went 4.81 -> 4.98 dB and the ddsp one's "
                        "4.84 -> 4.91 dB; score the fine-tuned tree "
                        "(cli.evaluate, tools/torch_quality.py) before "
                        "using it.  Needs --prepared_dir")
    p.add_argument("--finetune_lr", type=float, default=3e-4)
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
    for flag, unused in UNSUPPORTED.items():
        if getattr(args, flag) != unused:
            p.error(f"--{flag} is not ported yet: {_MULTI}")
    if not args.synthetic and not args.prepared_dir:
        p.error("need --prepared_dir or --synthetic")
    if args.finetune_converted and not args.prepared_dir:
        p.error("--finetune_converted needs --prepared_dir (it fine-tunes "
                "on the prepared corpus's converted features)")
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

    if args.synthetic:
        seconds = args.crop_frames * cfg.dsp.hop / cfg.dsp.sample_rate

        def next_batch(step: int):
            return make_batch(cfg, args.batch_size, seconds=seconds,
                              seed=args.seed + step, device=device)
    else:
        ds = CorpusDataset(args.prepared_dir, cfg,
                           crop_frames=args.crop_frames, seed=args.seed,
                           cache_utterances=args.cache_utterances,
                           device=device)
        print(f"[train] corpus: {ds.num_utterances} utterance pairs")

        def next_batch(step: int):
            return ds.sample_batch(args.batch_size)

    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = next_batch(step)
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

    # --gan: the inference tree is the EMA generator
    final = state.ema_params if args.gan else state.params
    if args.finetune_converted:
        from realtime_yukarin_tpu_torch.training.full_chain import (
            converted_pairs, finetune_vocoder_on_converted)
        pairs = converted_pairs(final, cfg, args.prepared_dir, device)
        print(f"[train] fine-tuning vocoders on {len(pairs)} converted-"
              f"feature utterances, {args.finetune_converted} steps")
        final = finetune_vocoder_on_converted(
            final, cfg, pairs, steps=args.finetune_converted,
            lr=args.finetune_lr, crop_frames=args.crop_frames,
            batch_size=args.batch_size, seed=args.seed, device=device)

    if args.export_params:
        save_params_npz(final, args.export_params)
        print(f"[train] inference params -> {args.export_params}")


if __name__ == "__main__":
    main()
