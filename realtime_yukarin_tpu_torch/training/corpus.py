"""Corpus preparation: wav dirs -> aligned feature pairs + F0 statistics
(PyTorch port of ``training/corpus.py``).

Every utterance of the source and target speakers is analysed on the
given device (on the card: one launch each of the power-spectrum and
envelope-cepstrum kernels per file, over all its frames, inside the
analysis program of ``pipeline.offline_analyze`` for its bucket's
length), same-stem
pairs are DTW-aligned (``training/align.py``), and per-speaker F0
statistics are written as ``stats_input.npz`` / ``stats_target.npz``.

Each file is zero-padded up to a multiple of ``bucket_frames`` before
analysis, as the JAX package pads it to bound its compiles.  The padding
is kept because it defines the result: the last true frames' F0 tracking
and envelope see the zeros after them.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature
from realtime_yukarin_tpu_torch.models.f0_stats import F0Statistics
from realtime_yukarin_tpu_torch.pipeline import offline_analyze
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.align import align_pair
from realtime_yukarin_tpu_torch.utils.audio_io import read_wav


def frame_bucket(num_frames: int, bucket_frames: int) -> int:
    """Round up to the bucket grid (>= one bucket)."""
    return max(1, -(-num_frames // bucket_frames)) * bucket_frames


def analyze_file(path: str | pathlib.Path, cfg: Config,
                 bucket_frames: int = 200, device=None
                 ) -> tuple[AcousticFeature, int, np.ndarray]:
    """Analyse one wav on ``device`` (``cuda`` unless the caller names
    another).

    Returns (features over the bucket-padded length, true frame count,
    the padded audio at the internal rate: the vocoders' training
    target)."""
    device = resolve_device(device)
    x, _ = read_wav(str(path), target_rate=cfg.dsp.sample_rate)
    hop = cfg.dsp.hop
    true_frames = max(1, len(x) // hop)
    F = frame_bucket(true_frames, bucket_frames)
    pad = F * hop - len(x)
    if pad > 0:
        x = np.concatenate([x, np.zeros(pad, np.float32)])
    x = np.asarray(x[: F * hop], np.float32)
    feat = offline_analyze(torch.from_numpy(x), cfg, F, device)
    return feat, true_frames, x


def _crop(feat: AcousticFeature, n: int) -> AcousticFeature:
    return AcousticFeature(f0=feat.f0[:n], env=feat.env[:n],
                           ap=feat.ap[:n], mc=feat.mc[:n])


def paired_wavs(src_dir: str, tgt_dir: str) -> list[tuple[pathlib.Path,
                                                          pathlib.Path]]:
    """Same-stem wav pairing."""
    src = {p.stem: p for p in sorted(pathlib.Path(src_dir).glob("*.wav"))}
    tgt = {p.stem: p for p in sorted(pathlib.Path(tgt_dir).glob("*.wav"))}
    stems = sorted(set(src) & set(tgt))
    return [(src[s], tgt[s]) for s in stems]


def _np(feat: AcousticFeature) -> dict[str, np.ndarray]:
    return {k: getattr(feat, k).cpu().numpy()
            for k in ("f0", "mc", "ap", "env")}


def prepare_corpus(src_dir: str, tgt_dir: str, out_dir: str, cfg: Config,
                   bucket_frames: int = 200, verbose: bool = True,
                   device=None) -> dict:
    """Analyse and align every pair on ``device`` (``cuda`` unless the
    caller names another); save one npz per pair and the F0 statistics.

    Each ``<stem>.npz`` holds the source features (``*_src``), the target
    features warped onto the source timeline (``*_tgt``), and the target
    on its own timeline with its raw audio (``*_voc``, ``wave_voc``: the
    self-vocoding pair, which needs no alignment).  Returns a summary
    (pair count, statistics)."""
    device = resolve_device(device)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pairs = paired_wavs(src_dir, tgt_dir)
    if not pairs:
        raise FileNotFoundError(
            f"no same-stem wav pairs under {src_dir} / {tgt_dir}")

    f0_src_all: list[np.ndarray] = []
    f0_tgt_all: list[np.ndarray] = []
    for sp, tp in pairs:
        fs, ns, _ = analyze_file(sp, cfg, bucket_frames, device)
        ft, nt, tgt_wave = analyze_file(tp, cfg, bucket_frames, device)
        fs_c, ft_c = _crop(fs, ns), _crop(ft, nt)
        aligned = align_pair(fs_c.mc, ft_c)
        src, tgt, voc = _np(fs_c), _np(aligned), _np(ft_c)
        np.savez(out / f"{sp.stem}.npz",
                 **{f"{k}_src": v for k, v in src.items()},
                 **{f"{k}_tgt": v for k, v in tgt.items()},
                 **{f"{k}_voc": v for k, v in voc.items()},
                 wave_voc=tgt_wave[: nt * cfg.dsp.hop])
        f0_src_all.append(src["f0"])
        f0_tgt_all.append(voc["f0"])   # unaligned: the true speaker stats
        if verbose:
            print(f"[prepare] {sp.stem}: src {ns}f, tgt {nt}f")

    stats_src = F0Statistics.from_f0(np.concatenate(f0_src_all))
    stats_tgt = F0Statistics.from_f0(np.concatenate(f0_tgt_all))
    stats_src.save(out / "stats_input.npz")
    stats_tgt.save(out / "stats_target.npz")
    return {"num_pairs": len(pairs),
            "stats_input": stats_src, "stats_target": stats_tgt}
