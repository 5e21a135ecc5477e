"""Offline file-to-file conversion CLI of the PyTorch port (port of
``cli/convert.py``).

Usage:
    python -m realtime_yukarin_tpu_torch.cli.convert \\
        --input_path in.wav --output_path out.wav \\
        [--config_path config.yaml] [--params_path params.npz] \\
        [--vocoder dsp|ddsp|wave|hifigan] [--neural_vocoder] [--no_sr] \\
        [--seed N] [--device cuda]

Reads the input at ``cfg.dsp.in_rate``, converts it through
``pipeline.offline_convert_io`` (which resamples to and from the internal
rate with the streaming step's plans) and writes it at
``cfg.dsp.out_rate``.  Runs on ``cuda`` unless ``--device`` names another
device (no fallback).  Parameters are read in the JAX package's ``.npz``
layout (``cli.train --export_params``) or its default flax ``.msgpack``;
``--seed`` selects the same noise as the JAX CLI's.
"""

from __future__ import annotations

import argparse

import torch

from realtime_yukarin_tpu_torch.config import VOCODER_MODES, Config
from realtime_yukarin_tpu_torch.models.vocoders import mode_from_flags
from realtime_yukarin_tpu_torch.models.voice_changer import (init_params,
                                                             load_all_params)
from realtime_yukarin_tpu_torch.pipeline import offline_convert_io
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    noise_key_from_seed, resolve_device)
from realtime_yukarin_tpu_torch.utils.audio_io import read_wav, write_wav


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--config_path", default=None)
    p.add_argument("--params_path", default=None,
                   help="full parameter tree (.npz or .msgpack)")
    p.add_argument("--neural_vocoder", action="store_true",
                   help="legacy spelling of --vocoder ddsp")
    p.add_argument("--vocoder", choices=list(VOCODER_MODES),
                   default=None, help="synthesis stage (default: config)")
    p.add_argument("--no_sr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config_path) if args.config_path else Config()
    mode = mode_from_flags(args.vocoder, args.neural_vocoder, cfg)
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                         device, vocoder_mode=mode)
    params = load_all_params(params, cfg, params_path=args.params_path)

    x, _ = read_wav(args.input_path, target_rate=cfg.dsp.in_rate)
    y = offline_convert_io(params, x, noise_key_from_seed(args.seed), cfg,
                           use_sr=not args.no_sr, vocoder_mode=mode,
                           device=device).cpu().numpy()
    write_wav(args.output_path, y, cfg.dsp.out_rate)
    print(f"wrote {args.output_path}: {len(y)} samples "
          f"@ {cfg.dsp.out_rate} Hz")


if __name__ == "__main__":
    main()
