"""Objective evaluation CLI of the PyTorch port (port of
``cli/evaluate.py``): MCD and F0 metrics between two waveforms.

Both wavs are analysed by the same front end (``dsp/world.py:analyze``)
on the device and compared frame by frame over the span they share.
Runs on ``cuda`` unless ``--device`` names another device (no fallback).

Usage:
    python -m realtime_yukarin_tpu_torch.cli.evaluate \\
        --converted_path conv.wav --target_path tgt.wav \\
        [--config_path cfg.yaml] [--device cuda]

Prints one JSON line:
{"mcd_db": ..., "logf0_rmse": ..., "vuv_error": ..., "frames": N}.
"""

from __future__ import annotations

import argparse
import json

import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature, analyze
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.evaluate import f0_metrics, mcd_db
from realtime_yukarin_tpu_torch.utils.audio_io import read_wav


def _analyze_wav(path: str, cfg: Config,
                 device: torch.device) -> AcousticFeature:
    x, _ = read_wav(path, target_rate=cfg.dsp.sample_rate)
    num_frames = max(1, len(x) // cfg.dsp.hop)
    return analyze(torch.from_numpy(x).to(device), num_frames, cfg.dsp)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--converted_path", required=True)
    p.add_argument("--target_path", required=True)
    p.add_argument("--config_path", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config_path) if args.config_path else Config()
    a = _analyze_wav(args.converted_path, cfg, device)
    b = _analyze_wav(args.target_path, cfg, device)

    F = min(a.f0.shape[0], b.f0.shape[0])
    mcd = float(mcd_db(a.mc[:F], b.mc[:F]))
    f0m = {k: float(v) for k, v in f0_metrics(a.f0[:F], b.f0[:F]).items()}
    print(json.dumps({"mcd_db": round(mcd, 4),
                      **{k: round(v, 4) for k, v in f0m.items()},
                      "frames": int(F)}))


if __name__ == "__main__":
    main()
