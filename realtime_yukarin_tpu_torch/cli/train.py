"""Training CLI of the PyTorch port (port of ``cli/train.py``).

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

Several ranks (one process per GPU, the same command on each): add
``--coordinator_address HOST:PORT --num_processes N --process_id R`` (or
set ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``)
and optionally ``--model_parallel M``.  Each rank trains on its own
``--batch_size`` rows; the global batch is the data ranks' rows together,
and the weights the shard rule selects split over groups of M consecutive
ranks (``parallel/mesh.py``).  Rank 0 logs, writes the checkpoints (whole,
after gathering the split), fine-tunes and exports.

``--export_params`` writes the JAX package's ``.npz`` layout (the EMA
generator under --gan, the fine-tuned tree after --finetune_converted),
which ``realtime_yukarin_tpu``'s ``load_params`` and this port's
``load_params_npz`` both read.

On CUDA each training step (and each fine-tune step) is one device
program: captured as a CUDA graph at its first call, after the restore
and the model split, and replayed; a run over several ranks steps eagerly
and says why.  The first step logs which.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.discriminator import init_discriminator
from realtime_yukarin_tpu_torch.models.voice_changer import (init_params,
                                                             save_params_npz)
from realtime_yukarin_tpu_torch.parallel.mesh import (check_divisible,
                                                      gather_params,
                                                      make_mesh)
from realtime_yukarin_tpu_torch.parallel.multihost import (
    broadcast_from_host0, init_multihost, rank_device)
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.checkpoint import (
    restore_checkpoint_to_all, save_checkpoint_from_host0)
from realtime_yukarin_tpu_torch.training.data import make_batch
from realtime_yukarin_tpu_torch.training.dataset import CorpusDataset
from realtime_yukarin_tpu_torch.training.train_step import (
    init_gan_train_state, init_train_state, make_gan_train_step,
    make_train_step, shard_train_state)

# a data rank's make_batch seed stride (the JAX package's per-host offset)
RANK_SEED_STRIDE = 1_000_003


def launch_world(args: argparse.Namespace) -> int:
    """The number of ranks the launch arguments (or the environment) name:
    1 without a coordinator."""
    if not (args.coordinator_address
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return 1
    if args.num_processes is not None:
        return args.num_processes
    return int(os.environ.get("JAX_NUM_PROCESSES", 1))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse, then refuse at once any combination the run would refuse
    later."""
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
                   help="split the selected weights' output channels over "
                        "groups of this many consecutive ranks; must "
                        "divide the number of ranks.  One process drives "
                        "one GPU (a JAX process can hold a whole mesh), "
                        "so M > 1 needs M processes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator_address", default=None,
                   help="rank 0's HOST:PORT for a multi-process run; every "
                        "rank runs this same command (default: "
                        "$JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="ranks in the run (default: $JAX_NUM_PROCESSES)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this rank (default: $JAX_PROCESS_ID)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on "
                        "cuda, gloo on cpu; gloo for ranks sharing a card)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: this rank's card; "
                        "no fallback)")
    args = p.parse_args(argv)
    try:
        check_divisible(launch_world(args), args.model_parallel)
    except ValueError as e:
        p.error(f"--model_parallel: {e}")
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
    rank, world = init_multihost(args.coordinator_address,
                                 args.num_processes, args.process_id,
                                 backend=args.backend, device=device)
    device = rank_device(device)
    mesh = make_mesh(args.model_parallel)
    is_host0 = rank == 0

    def log(msg: str) -> None:
        if is_host0:
            print(msg)

    if world > 1:
        log(f"[train] {world} ranks: data {mesh.data_size} x model "
            f"{mesh.model_parallel}, {args.batch_size} rows per data rank")
    cfg = Config.from_yaml(args.config_path) if args.config_path else Config()
    params = broadcast_from_host0(
        init_params(cfg, torch.Generator().manual_seed(cfg.seed)))
    if args.gan:
        disc = broadcast_from_host0(init_discriminator(
            cfg.super_resolution, cfg.dsp,
            torch.Generator().manual_seed(cfg.seed + 1)))
        state = init_gan_train_state(params, disc, device, args.lr)
    else:
        state = init_train_state(params, device, args.lr)

    # resume before the split: a checkpoint holds the whole state, and
    # every rank takes rank 0's (no shared file system needed)
    start_step = 0
    if args.ckpt_dir:
        state, start_step = restore_checkpoint_to_all(args.ckpt_dir, state)
        if start_step:
            log(f"[train] resumed from step {start_step}")
    state = shard_train_state(mesh, state)
    # the step is captured at its first call, over the state as it is now
    step_fn = (make_gan_train_step(cfg, args.adv_weight, mesh=mesh)
               if args.gan else make_train_step(cfg, mesh))

    # every rank of a model group feeds the same rows: the seeds follow
    # the data index (the rank itself at model_parallel 1)
    data_index = mesh.data_index
    if args.synthetic:
        seconds = args.crop_frames * cfg.dsp.hop / cfg.dsp.sample_rate

        def next_batch(step: int):
            return make_batch(cfg, args.batch_size, seconds=seconds,
                              seed=args.seed + step
                              + data_index * RANK_SEED_STRIDE,
                              device=device)
    else:
        ds = CorpusDataset(args.prepared_dir, cfg,
                           crop_frames=args.crop_frames,
                           seed=args.seed + data_index,
                           cache_utterances=args.cache_utterances,
                           device=device)
        log(f"[train] corpus: {ds.num_utterances} utterance pairs")

        def next_batch(step: int):
            return ds.sample_batch(args.batch_size)

    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = next_batch(step)
        state, metrics = step_fn(state, batch)
        if step == start_step:
            log(f"[train] {step_fn.summary()}")
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (step + 1 - start_step) / (time.perf_counter() - t0)
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
            log(f"[train] step {step + 1}/{args.steps} {msg} "
                f"({rate:.2f} it/s on {device})")
        if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                              or step + 1 == args.steps):
            path = save_checkpoint_from_host0(args.ckpt_dir, state, step + 1,
                                              mesh)
            log(f"[train] checkpoint -> {path}")

    # --gan: the inference tree is the EMA generator
    final = gather_params(mesh, state.ema_params if args.gan
                          else state.params)
    if args.finetune_converted:
        if is_host0:
            from realtime_yukarin_tpu_torch.training.full_chain import (
                converted_pairs, finetune_vocoder_on_converted)
            pairs = converted_pairs(final, cfg, args.prepared_dir, device)
            print(f"[train] fine-tuning vocoders on {len(pairs)} "
                  f"converted-feature utterances, "
                  f"{args.finetune_converted} steps")
            final = finetune_vocoder_on_converted(
                final, cfg, pairs, steps=args.finetune_converted,
                lr=args.finetune_lr, crop_frames=args.crop_frames,
                batch_size=args.batch_size, seed=args.seed, device=device)
        final = broadcast_from_host0(final)

    if args.export_params and is_host0:
        save_params_npz(final, args.export_params)
        print(f"[train] inference params -> {args.export_params}")


if __name__ == "__main__":
    main()
