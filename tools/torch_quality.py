"""Conversion quality of the PyTorch port: the JAX package's quality recipe
(``tools/quality.py``, whose output is ``QUALITY.json``) run through
``realtime_yukarin_tpu_torch`` on one device.

  1. build the two-speaker formant corpus (``training/data.py:
     build_formant_corpus``: fixed seeds, the same WAVs as the JAX
     package's) and prepare it on the device,
  2. train the tiny config 600 steps (``training/full_chain.py:
     train_plain``) and install the corpus's F0 statistics,
  3. convert the held-out source waveform through the streamed pipeline
     in every vocoder mode for the identity-init and the trained trees,
     and score the output audio against the aligned target features,
  4. measure the vocoders' conditioning gap, fine-tune them 300 steps on
     converted features (``cli.train --finetune_converted``), and measure
     the gap and the full chain (ddsp, wave) again.

Prints ``QUALITY.json``'s structure as one JSON document (or writes it to
``--out``); ``QUALITY.json`` itself is the JAX package's record and is not
written.  Runs on ``cuda`` unless ``--device`` names another device.

Usage: python3 tools/torch_quality.py [--device cuda] [--out q.json]
           [--steps 600] [--finetune_steps 300] [--work_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

MODES = ("dsp", "ddsp", "wave")


def quality_config():
    """The tiny model config of the held-out gates (tests/conftest.py)."""
    from realtime_yukarin_tpu_torch.config import (AcousticModelConfig,
                                                   Config,
                                                   SuperResolutionConfig,
                                                   VocoderNNConfig)
    return Config(acoustic=AcousticModelConfig(hidden=32, num_blocks=2),
                  super_resolution=SuperResolutionConfig(hidden=64,
                                                         num_blocks=2),
                  vocoder_nn=VocoderNNConfig(hidden=32, num_blocks=2))


def run_quality(device=None, steps: int = 600, finetune_steps: int = 300,
                work_dir=None, log=print) -> dict:
    """The whole recipe on ``device``; returns QUALITY.json's structure."""
    import torch

    from realtime_yukarin_tpu_torch.models.f0_stats import (F0Statistics,
                                                            f0_stats_params)
    from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
    from realtime_yukarin_tpu_torch.training import full_chain as FC
    from realtime_yukarin_tpu_torch.training.data import build_formant_corpus
    from realtime_yukarin_tpu_torch.utils.audio_io import read_wav

    device = resolve_device(device)
    cfg = quality_config()
    work = pathlib.Path(work_dir or tempfile.mkdtemp(prefix="quality_"))
    t0 = time.perf_counter()
    dirs = build_formant_corpus(work, cfg, device=device)
    log(f"[quality] corpus built ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    init_p, trained = FC.train_plain(cfg, dirs["prep_tr"], steps=steps,
                                     device=device)
    log(f"[quality] trained {steps} steps "
        f"({time.perf_counter() - t0:.1f} s)")
    si = F0Statistics.load(dirs["prep_tr"] / "stats_input.npz")
    st = F0Statistics.load(dirs["prep_tr"] / "stats_target.npz")
    trained = dict(trained, f0_stats=f0_stats_params(si, st, device))

    with np.load(dirs["prep_ev"] / "ho.npz") as z:
        ho = dict(z)
    src_wave, _ = read_wav(str(dirs["ev_src"] / "ho.wav"),
                           target_rate=cfg.dsp.sample_rate)

    t0 = time.perf_counter()
    m_init = FC.full_chain_metrics(init_p, cfg, src_wave, ho, MODES,
                                   device=device)
    m_tr = FC.full_chain_metrics(trained, cfg, src_wave, ho, MODES,
                                 device=device)
    log(f"[quality] full-chain metrics ({time.perf_counter() - t0:.1f} s)")
    for mode in m_tr:
        log(f"  {mode}: mcd {m_init[mode]['mcd_db']:.3f} -> "
            f"{m_tr[mode]['mcd_db']:.3f} dB, logf0 "
            f"{m_init[mode]['logf0_rmse']:.3f} -> "
            f"{m_tr[mode]['logf0_rmse']:.3f}, vuv "
            f"{m_tr[mode]['vuv_error']:.4f}")

    t0 = time.perf_counter()
    gap = FC.conditioning_gap(trained, cfg, ho, device=device)
    pairs = FC.converted_pairs(trained, cfg, dirs["prep_tr"], device=device)
    ft = FC.finetune_vocoder_on_converted(trained, cfg, pairs,
                                          steps=finetune_steps,
                                          device=device)
    gap_ft = FC.conditioning_gap(ft, cfg, ho, device=device)
    m_ft = FC.full_chain_metrics(ft, cfg, src_wave, ho, ("ddsp", "wave"),
                                 device=device)
    log(f"[quality] conditioning gap + fine-tune "
        f"({time.perf_counter() - t0:.1f} s)")
    for mode in gap:
        log(f"  {mode}: ratio {gap[mode]['ratio']:.4f} -> "
            f"{gap_ft[mode]['ratio']:.4f} after {finetune_steps}-step "
            f"fine-tune")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {
        "round": None,
        "recipe": {
            "corpus": "formant-class 6-pair + 1 held-out "
                      "(training.data.build_formant_corpus, fixed seeds)",
            "train_steps": steps,
            "finetune_converted_steps": finetune_steps,
            "platform": device.type,
            "device": kind,
            "package": "realtime_yukarin_tpu_torch",
            "note": "full_chain = held-out source WAVEFORM through the "
                    "complete STREAMED trained pipeline; output audio "
                    "re-analyzed and scored vs DTW-aligned target "
                    "features.  conditioning = vocoder loss vs the real "
                    "target waveform under ground-truth vs converted "
                    "feature conditioning (real target F0 in both).",
        },
        "full_chain_identity_baseline": m_init,
        "full_chain_trained": m_tr,
        "full_chain_trained_finetuned": m_ft,
        "vocoder_conditioning": {
            "trained": gap,
            "after_finetune_converted": gap_ft,
        },
    }


def quality_gates(doc: dict) -> list[tuple[str, bool]]:
    """The JAX package's held-out gates (tests/test_full_chain.py) on a
    recipe's result: [(what, passed)]."""
    m_init = doc["full_chain_identity_baseline"]
    m_tr = doc["full_chain_trained"]
    out = []
    for mode in MODES:
        i, t = m_init[mode], m_tr[mode]
        out += [
            (f"{mode}: trained MCD {t['mcd_db']:.3f} at least 0.6 dB below "
             f"identity {i['mcd_db']:.3f}", t["mcd_db"] < i["mcd_db"] - 0.6),
            (f"{mode}: trained log-F0 RMSE {t['logf0_rmse']:.4f} at least "
             f"0.1 below identity {i['logf0_rmse']:.4f}",
             t["logf0_rmse"] < i["logf0_rmse"] - 0.1),
            (f"{mode}: trained log-F0 RMSE {t['logf0_rmse']:.4f} < 0.25",
             t["logf0_rmse"] < 0.25),
            (f"{mode}: V/UV error {t['vuv_error']:.4f} < 0.06",
             t["vuv_error"] < 0.06),
            (f"{mode}: trained MCD {t['mcd_db']:.3f} < 5.4 dB",
             t["mcd_db"] < 5.4),
        ]
    for mode, m in doc["full_chain_trained_finetuned"].items():
        out.append((f"{mode}: fine-tuned MCD {m['mcd_db']:.3f} < 5.4 dB",
                    m["mcd_db"] < 5.4))
    gap = doc["vocoder_conditioning"]["trained"]
    gap_ft = doc["vocoder_conditioning"]["after_finetune_converted"]
    for mode, g in gap.items():
        f = gap_ft[mode]
        out += [
            (f"{mode}: conditioning ratio {g['ratio']:.4f} in (0.95, 1.5)",
             0.95 < g["ratio"] < 1.5),
            (f"{mode}: fine-tune lowers the converted loss by > 0.004 "
             f"({g['converted']:.4f} -> {f['converted']:.4f})",
             f["converted"] < g["converted"] - 0.004),
            (f"{mode}: fine-tune keeps the ground-truth loss within 5% "
             f"({g['gt']:.4f} -> {f['gt']:.4f})",
             f["gt"] < g["gt"] * 1.05),
        ]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback)")
    p.add_argument("--out", default=None,
                   help="write the JSON here (default: stdout)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--finetune_steps", type=int, default=300)
    p.add_argument("--work_dir", default=None,
                   help="corpus/work dir (default: a temp dir)")
    args = p.parse_args(argv)
    doc = run_quality(args.device, args.steps, args.finetune_steps,
                      args.work_dir,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
    text = json.dumps(doc, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    else:
        print(text)


if __name__ == "__main__":
    main()
