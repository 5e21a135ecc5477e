"""Corpus training in plain PyTorch: a pair's preparation (analysis, DTW
alignment), the random crops a corpus sampler draws, the joint objective,
per-stage clipping and AdamW.

The preparation reads the same 16-bit WAV files the program reads and
computes every feature itself; the sampler follows the same draws from the
same seed, so it picks the same utterances, crops and noise.  The step is
the joint objective of stage 1 (mel-cepstrum L1), stage 2 (log-envelope
L2) and both neural vocoders (multi-resolution STFT against the real
target waveform), float32, each top-level subtree's gradient clipped to
norm 1, then ``torch.optim.AdamW`` (lr 1e-4, weight decay 1e-5).
"""

from __future__ import annotations

import dataclasses
import wave

import numpy as np
import torch

from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.framing import hann
from benchmark.reference.dsp.mcep import decode_mcep
from benchmark.reference.dsp.world import analyze
from benchmark.reference.models.acoustic import convert_mc
from benchmark.reference.models.super_resolution import refine_envelope
from benchmark.reference.models.vocoder_nn import neural_vocode
from benchmark.reference.models.vocoder_wave import waveform_vocode

LR = 1e-4
WEIGHT_DECAY = 1e-5
MAX_NORM = 1.0
F0_STAT_NAMES = ("src_mean", "src_std", "tgt_mean", "tgt_std")
ALIGNED = ("f0_src", "mc_src", "ap_src", "f0_tgt", "mc_tgt", "env_tgt")
VOC = ("f0_voc", "mc_voc", "ap_voc", "env_voc")


def read_wav(path) -> np.ndarray:
    """16-bit mono PCM -> float32 in [-1, 1)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: not 16-bit mono")
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def frames_of(path, hop: int) -> int:
    with wave.open(str(path), "rb") as w:
        return max(1, w.getnframes() // hop)


def _analyze(path, cfg, bucket: int, device):
    """(features of the true frames, true frames, audio padded to the
    bucket): the file padded with zeros to a whole number of buckets and
    analysed over that length."""
    x = read_wav(path)
    hop = cfg.dsp.hop
    n = max(1, len(x) // hop)
    F = max(1, -(-n // bucket)) * bucket
    x = np.concatenate([x, np.zeros(max(0, F * hop - len(x)), np.float32)])
    x = x[: F * hop]
    with torch.no_grad():
        feat = analyze(torch.from_numpy(x).to(device), F, cfg.dsp)
    return {k: getattr(feat, k)[:n] for k in ("f0", "mc", "ap", "env")}, \
        n, x


def dtw_path(x: torch.Tensor, y: torch.Tensor) -> np.ndarray:
    """Monotonic alignment (steps of 0, 1 or 2 target frames per source
    frame, from (0, 0) to the last frames) minimising the summed squared
    euclidean distance; ties take the fewest columns back."""
    x, y = x.float(), y.float()
    C = torch.clamp((x * x).sum(-1)[:, None] + (y * y).sum(-1)[None]
                    - 2.0 * x @ y.T, min=0.0).cpu().numpy()
    Fx, Fy = C.shape
    big = np.float32(1e30)
    prev = np.full(Fy, big, np.float32)
    prev[0] = C[0, 0]
    back = np.zeros((Fx, Fy), np.int8)
    for i in range(1, Fx):
        c0 = prev
        c1 = np.concatenate([[big], prev[:-1]])
        c2 = np.concatenate([[big, big], prev[:-2]])
        take1 = c1 < c0
        best = np.where(take1, c1, c0)
        take2 = c2 < best
        back[i] = np.where(take2, 2, take1.astype(np.int8))
        prev = C[i] + np.where(take2, c2, best)
    idx = np.empty(Fx, np.int64)
    j = Fy - 1
    for i in range(Fx - 1, -1, -1):
        idx[i] = j
        j -= int(back[i, j])
    return idx


def prepare_pair(src_path, tgt_path, cfg, bucket: int, device) -> dict:
    """A pair's arrays: source features (``*_src``), target features
    warped onto the source timeline (``*_tgt``), the target on its own
    timeline (``*_voc``) and its audio (``wave_voc``)."""
    src, _, _ = _analyze(src_path, cfg, bucket, device)
    tgt, nt, wave_t = _analyze(tgt_path, cfg, bucket, device)
    idx = torch.from_numpy(dtw_path(src["mc"][:, 1:], tgt["mc"][:, 1:])
                           ).to(device)
    out = {f"{k}_src": v for k, v in src.items()}
    out.update({f"{k}_tgt": v.index_select(0, idx) for k, v in tgt.items()})
    out.update({f"{k}_voc": v for k, v in tgt.items()})
    out["wave_voc"] = torch.from_numpy(wave_t[: nt * cfg.dsp.hop]).to(device)
    return out


def _crop(a: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """n rows from ``start``, the last row repeated past the end."""
    F = a.shape[0]
    if F >= start + n:
        return a[start: start + n]
    return torch.cat([a[start:], a[-1:].expand(start + n - F,
                                               *a.shape[1:])])


class Sampler:
    """The crops a corpus sampler draws (``crop`` frames plus one, the
    renderer's lookahead) from a numpy generator seeded with ``seed``:
    per row an utterance, an aligned start, a start on the target's own
    timeline; then the batch's noise.  Pairs are prepared when first
    drawn."""

    def __init__(self, pairs: list, cfg, crop: int, seed, bucket: int,
                 device):
        self.pairs, self.cfg, self.F = pairs, cfg, crop
        self.bucket, self.device = bucket, device
        self.rng = np.random.default_rng(seed)
        hop = cfg.dsp.hop
        self.frames = [(frames_of(s, hop), frames_of(t, hop))
                       for s, t in pairs]
        self.prepared: dict[int, dict] = {}
        self.k_noise = prim.noise_fft_size(hop) // 2 + 1

    def _pair(self, i: int) -> dict:
        if i not in self.prepared:
            self.prepared[i] = prepare_pair(*self.pairs[i], self.cfg,
                                            self.bucket, self.device)
        return self.prepared[i]

    def batch(self, size: int) -> dict:
        F, hop = self.F, self.cfg.dsp.hop
        rows = {k: [] for k in ALIGNED + VOC}
        waves = []
        for _ in range(size):
            i = int(self.rng.integers(len(self.pairs)))
            ns, nt = self.frames[i]
            s = int(self.rng.integers(max(0, ns - (F + 1)) + 1))
            s2 = int(self.rng.integers(max(0, min(nt - (F + 1),
                                                  nt - F)) + 1))
            u = self._pair(i)
            for k in ALIGNED:
                rows[k].append(_crop(u[k], s, F + 1))
            for k in VOC:
                rows[k].append(_crop(u[k], s2, F + 1))
            waves.append(_crop(u["wave_voc"].reshape(-1, hop), s2,
                               F).reshape(-1))
        noise = self.rng.standard_normal((size, F, self.k_noise, 2))
        out = {k: torch.stack(v) for k, v in rows.items()}
        out["wave_voc"] = torch.stack(waves)
        out["noise"] = torch.from_numpy(noise.astype(np.float32)).to(
            self.device)
        return out


def _stft_mag(x: torch.Tensor, fft: int, hop: int) -> torch.Tensor:
    T = x.shape[-1]
    n = max((T - fft) // hop + 1, 1)
    idx = (torch.arange(n, device=x.device)[:, None] * hop
           + torch.arange(fft, device=x.device))
    frames = x[..., torch.clamp(idx, max=T - 1)] * hann(fft, like=x)
    return torch.abs(torch.fft.rfft(frames, dim=-1))


def stft_loss(pred, target, ffts=(512, 1024, 2048)) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1, averaged over
    resolutions (hop fft / 4)."""
    total = 0.0
    for fft in ffts:
        mp = _stft_mag(pred, fft, fft // 4)
        mt = _stft_mag(target, fft, fft // 4)
        sc = (torch.linalg.vector_norm(mp - mt)
              / (torch.linalg.vector_norm(mt) + 1e-6))
        lm = torch.mean(torch.abs(torch.log(mp + 1e-6)
                                  - torch.log(mt + 1e-6)))
        total = total + sc + lm
    return total / len(ffts)


def joint_loss(params: dict, b: dict, cfg, dtype=torch.float32
               ) -> torch.Tensor:
    mc_pred = convert_mc(params["stage1"], b["mc_src"], b["f0_src"],
                         cfg.acoustic, dtype)
    l_mc = torch.mean(torch.abs(mc_pred - b["mc_tgt"]))
    env_low = decode_mcep(mc_pred, cfg.dsp)
    env_pred = refine_envelope(params["stage2"], env_low,
                               cfg.super_resolution, cfg.dsp, dtype)
    lp = torch.log(torch.clamp(env_pred, min=1e-12))
    lt = torch.log(torch.clamp(b["env_tgt"], min=1e-12))
    l_env = torch.mean((lp - lt) ** 2)
    w1, _ = neural_vocode(params["vocoder"], b["f0_voc"], b["env_voc"],
                          b["ap_voc"], b["mc_voc"], b["noise"],
                          cfg.vocoder_nn, cfg.dsp, dtype=dtype)
    w2, _ = waveform_vocode(params["vocoder_wave"], b["f0_voc"],
                            b["env_voc"], b["ap_voc"], b["mc_voc"],
                            b["noise"], cfg.vocoder_wave, cfg.dsp,
                            dtype=dtype)
    return (l_mc + l_env + 0.5 * stft_loss(w1, b["wave_voc"])
            + 0.5 * stft_loss(w2, b["wave_voc"]))


def leaves(params: dict) -> dict[str, list]:
    """{subtree: its tensors}: modules in ``parameters()`` order, the F0
    statistics by name."""
    return {k: (list(v.parameters()) if isinstance(v, torch.nn.Module)
                else [v[n] for n in F0_STAT_NAMES])
            for k, v in params.items()}


@dataclasses.dataclass
class Step:
    """One joint step's readings: its loss and the clipped gradients as
    the optimizer got them, by subtree."""

    loss: float
    grads: dict


def train_step(params: dict, opt, b: dict, cfg) -> Step:
    groups = leaves(params)
    flat = [p for ps in groups.values() for p in ps]
    loss = joint_loss(params, b, cfg)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]
    out, i = {}, 0
    with torch.no_grad():
        for k, ps in groups.items():
            g = gs[i: i + len(ps)]
            i += len(ps)
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            scale = torch.clamp(MAX_NORM / torch.clamp(norm, min=1e-16),
                                max=1.0)
            out[k] = [x * scale for x in g]
        for p, g in zip(flat, (x for k in groups for x in out[k])):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
    return Step(loss=float(loss.detach()), grads=out)


def optimizer(params: dict) -> torch.optim.AdamW:
    flat = [p for ps in leaves(params).values() for p in ps]
    return torch.optim.AdamW(flat, lr=LR, weight_decay=WEIGHT_DECAY)
