"""Prepared-corpus dataset: npz pair files -> fixed-shape training Batches
(PyTorch port of ``training/dataset.py``).

Consumes ``training/corpus.py:prepare_corpus``'s output (one npz per
aligned utterance pair) and crops random fixed-length windows, two per
sample:
  * the ALIGNED window (``*_src`` / ``*_tgt``) feeds the conversion
    stages' regression losses;
  * the SELF-VOCODING window (``*_voc`` + ``wave_voc``) pairs the target
    speaker's features with the real waveform of the same frames on the
    target's own timeline, which the neural vocoders train against.

Draws come from one numpy generator in the JAX package's order, so the
same prepared dir and seed give the same batches bit for bit.
"""

from __future__ import annotations

import collections
import pathlib

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.training.train_step import Batch
from realtime_yukarin_tpu_torch.utils import profiling

ALIGNED = ("f0_src", "mc_src", "ap_src", "f0_tgt", "mc_tgt", "env_tgt")
VOC = ("f0_voc", "mc_voc", "ap_voc", "env_voc")


def crop_rows(arr: np.ndarray, start: int, n: int) -> np.ndarray:
    """Window of n rows starting at ``start``, edge-padded if short."""
    F = arr.shape[0]
    if F >= start + n:
        return arr[start: start + n]
    reps = np.repeat(arr[-1:], start + n - F, axis=0)
    return np.concatenate([arr[start:], reps], axis=0)


class CorpusDataset:
    """Random-crop batch sampler over prepared pair npz files, returning
    Batches on ``device`` (``cuda`` unless the caller names another).

    ``cache_utterances`` bounds host RAM: None (default) loads the whole
    corpus at once; an int loads utterances lazily behind an LRU of that
    many, while sampling stays uniform over the whole corpus.
    """

    def __init__(self, prepared_dir: str, cfg: Config, crop_frames: int = 100,
                 seed: int = 0, cache_utterances: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        d = pathlib.Path(prepared_dir)
        self._files = sorted(p for p in d.glob("*.npz")
                             if not p.stem.startswith("stats"))
        if not self._files:
            raise FileNotFoundError(f"no pair npz files in {prepared_dir}")
        self._cache_max = cache_utterances
        self._lru: collections.OrderedDict[int, dict] = \
            collections.OrderedDict()
        if cache_utterances is None:
            self._data = [self._check(self._read(p), p) for p in self._files]
        else:
            self._data = None
            self._check(self._load(0), self._files[0])
        self._cfg = cfg
        self._F = crop_frames
        self._rng = np.random.default_rng(seed)
        self._k_noise = prim.noise_fft_size(cfg.dsp.hop) // 2 + 1

    @staticmethod
    def _read(p: pathlib.Path) -> dict:
        with np.load(p) as z:
            return dict(z)

    @staticmethod
    def _check(u: dict, p: pathlib.Path) -> dict:
        if "wave_voc" not in u:
            raise KeyError(
                f"{p} lacks the self-vocoding arrays (wave_voc/*_voc) "
                f"— re-run prepare_corpus (the vocoder target is real "
                f"audio, not a DSP render)")
        return u

    def _load(self, i: int) -> dict:
        """Utterance i, through the LRU when one is configured."""
        if self._data is not None:
            return self._data[i]
        u = self._lru.get(i)
        if u is not None:
            self._lru.move_to_end(i)
            return u
        u = self._read(self._files[i])
        self._lru[i] = u
        while len(self._lru) > self._cache_max:
            self._lru.popitem(last=False)
        return u

    @property
    def num_utterances(self) -> int:
        return len(self._files)

    def sample_batch(self, batch_size: int) -> Batch:
        """``batch_size`` random crops and their noise on the host (span
        ``host.data.draw``), then each field stacked and copied to the
        device (``host.data.copy_in``)."""
        F = self._F
        hop = self._cfg.dsp.hop
        rows = {k: [] for k in ALIGNED + VOC}
        waves = []
        with profiling.span("host.data.draw"):
            for _ in range(batch_size):
                u = self._load(int(self._rng.integers(len(self._files))))
                max_start = max(0, u["f0_src"].shape[0] - (F + 1))
                s = int(self._rng.integers(max_start + 1))
                for k in ALIGNED:
                    rows[k].append(crop_rows(u[k], s, F + 1))
                # independent crop on the target's own timeline, bounded so
                # the raw-audio window [s2*hop, (s2+F)*hop) exists in full
                Fv = u["f0_voc"].shape[0]
                max_v = max(0, min(Fv - (F + 1),
                                   len(u["wave_voc"]) // hop - F))
                s2 = int(self._rng.integers(max_v + 1))
                for k in VOC:
                    rows[k].append(crop_rows(u[k], s2, F + 1))
                waves.append(crop_rows(u["wave_voc"].reshape(-1, hop), s2,
                                       F).reshape(-1))
            noise = self._rng.standard_normal(
                (batch_size, F, self._k_noise, 2))

        def dev(a) -> torch.Tensor:
            return torch.from_numpy(
                np.asarray(a, np.float32)).to(self.device)

        with profiling.span("host.data.copy_in"):
            return Batch(wave_voc=dev(np.stack(waves)), noise=dev(noise),
                         **{k: dev(np.stack(v)) for k, v in rows.items()})
