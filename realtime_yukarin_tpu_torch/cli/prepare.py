"""Corpus preparation CLI of the PyTorch port (port of ``cli/prepare.py``).

Analyses paired source/target wav directories on the device, DTW-aligns
each same-stem pair, and writes per-pair feature npz files plus
per-speaker F0 statistics (``stats_input.npz`` / ``stats_target.npz``),
the files ``cli.train --prepared_dir`` reads.  Runs on ``cuda`` unless
``--device`` names another device (no fallback).

Usage:
    python -m realtime_yukarin_tpu_torch.cli.prepare \\
        --src_dir corpora/src --tgt_dir corpora/tgt --out_dir prepared/ \\
        [--config_path config.yaml] [--bucket_frames 200] [--device cuda]
"""

from __future__ import annotations

import argparse

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.corpus import prepare_corpus


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src_dir", required=True)
    p.add_argument("--tgt_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--config_path", default=None)
    p.add_argument("--bucket_frames", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config_path) if args.config_path else Config()
    summary = prepare_corpus(args.src_dir, args.tgt_dir, args.out_dir, cfg,
                             bucket_frames=args.bucket_frames, device=device)
    si, st = summary["stats_input"], summary["stats_target"]
    print(f"[prepare] {summary['num_pairs']} pairs -> {args.out_dir}")
    print(f"[prepare] F0 stats input:  mean={si.mean:.4f} std={si.std:.4f}")
    print(f"[prepare] F0 stats target: mean={st.mean:.4f} std={st.std:.4f}")


if __name__ == "__main__":
    main()
