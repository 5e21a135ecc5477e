"""F0 estimation — vectorized YIN/CMND (PyTorch port of ``dsp/f0.py``).

Dio/Harvest + StoneMask roles as fixed-shape tensor math: the squared-
difference function for all lags at once (DFT-matmul cross-correlation
plus running energies), first-dip search as a masked argmax, parabolic
refinement, octave-down verification, a top-K candidate lattice with a
bounded-window Viterbi, band-evidence voicing revision and a full-rate
refinement on the shared power spectrogram.

Ties: ``torch.argmin``/``argmax`` return the first extremal index on CPU
and CUDA, as ``jnp.argmin``/``argmax`` do; the many ``_BIG`` entries of
the candidate and Viterbi tables rely on that.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from benchmark.reference.config import DspConfig
from benchmark.reference.dsp import primitives as prim
from benchmark.reference.dsp.envelope import power_spectrogram
from benchmark.reference.dsp.framing import (extract_centered_frames,
                                                    median3)
from benchmark.reference.ops import dft

# Finite "infinity" for masked min-plus DP (inf - inf = nan; a finite
# sentinel keeps every where/min well-defined in float32).
_BIG = 1.0e6


@functools.lru_cache(maxsize=None)
def _decim_matrix(decim: int, half_width: int, out_len: int) -> np.ndarray:
    """[decim*out_len + 2*half_width, out_len] banded anti-alias +
    downsample map, applied per frame."""
    h = prim.f0_decim_filter(decim, half_width)
    FL = decim * out_len + 2 * half_width
    D = np.zeros((FL, out_len), np.float64)
    for m in range(out_len):
        D[m * decim: m * decim + 2 * half_width + 1, m] = h
    return D


@functools.lru_cache(maxsize=None)
def _running_energy_matrix(frame_len: int, window: int, lag_max: int
                           ) -> np.ndarray:
    """[frame_len, lag_max+1] 0/1 band: e(l) = sum_{n=l}^{l+W-1} x^2[n]."""
    W = np.zeros((frame_len, lag_max + 1), np.float64)
    for l in range(lag_max + 1):
        W[l: l + window, l] = 1.0
    return W


def difference_function(frames: torch.Tensor, window: int, lag_max: int
                        ) -> torch.Tensor:
    """d[l] = sum_{n<W} (x[n]-x[n+l])^2 for l in [0, lag_max], per row,
    as d(l) = e0 + e(l) - 2 c(l) with c a DFT-matmul cross-correlation
    (DFT size: frame_len rounded up to even)."""
    F, FL = frames.shape
    n = FL + (FL & 1)
    a = torch.zeros((F, n), dtype=frames.dtype, device=frames.device)
    a[:, :window] = frames[:, :window]
    b = torch.zeros((F, n), dtype=frames.dtype, device=frames.device)
    b[:, :FL] = frames
    c = dft.cross_correlation(a, b, n, lag_max + 1)           # [F, L+1]
    Wb = dft.device_const(_running_energy_matrix, FL, window, lag_max,
                          like=frames)
    e = (frames * frames) @ Wb                                # [F, L+1]
    e0 = e[:, :1]
    return torch.clamp(e0 + e - 2.0 * c, min=0.0)


def cmnd(d: torch.Tensor) -> torch.Tensor:
    """Cumulative-mean-normalized difference; d'[0] = 1."""
    F, L1 = d.shape
    M = dft.device_const(dft.prefix_sum_matrix, L1 - 1, like=d)
    csum = d[:, 1:] @ M
    lags = torch.arange(1, L1, dtype=d.dtype, device=d.device)
    dp = torch.where(csum > 0, d[:, 1:] * lags / csum,
                     torch.ones_like(csum))
    return torch.cat([torch.ones((F, 1), dtype=d.dtype, device=d.device),
                      dp], dim=1)


def _pick(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[f, idx[f]] per row."""
    return torch.gather(values, 1, idx[:, None].to(torch.int64))[:, 0]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 where none), as jnp.argmax."""
    return torch.argmax(mask.to(torch.float32), dim=1)


def _cmnd_and_energy(x: torch.Tensor, num_frames: int, cfg: DspConfig,
                     center_offset: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Framing, anti-alias + decimate, per-frame mean removal, CMND.
    x [..., T]; returns (dp [..., F, lag_max_d+1], frame energy e0
    [..., F]).  The frames of every leading index go through the matmuls
    as one batch of rows."""
    hop, W = cfg.hop, cfg.f0_window_d
    frames = extract_centered_frames(x, num_frames, hop, cfg.f0_frame_len,
                                     center_offset)
    lead = frames.shape[:-1]
    frames = frames.reshape(-1, frames.shape[-1])
    if cfg.f0_decimation > 1:
        D = dft.device_const(_decim_matrix, cfg.f0_decimation,
                             cfg.f0_aa_half, cfg.f0_frame_len_d, like=x)
        frames = frames @ D
    frames = frames - torch.mean(frames, dim=1, keepdim=True)
    d = difference_function(frames, W, cfg.lag_max_d)
    dp = cmnd(d)                                              # [F, lmax+1]
    e0 = torch.sum(frames[:, :W] ** 2, dim=1)
    return dp.reshape(*lead, dp.shape[-1]), e0.reshape(lead)


def _parabolic(dm1, d0, dp1, tau, lmin, lmax, dtype):
    denom = dm1 - 2.0 * d0 + dp1
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (dm1 - dp1) / safe,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    interior = (tau > lmin) & (tau < lmax)
    return tau.to(dtype) + torch.where(interior, delta,
                                       torch.zeros_like(delta))


def _select_f0_from_cmnd(dp: torch.Tensor, e0: torch.Tensor, cfg: DspConfig
                         ) -> torch.Tensor:
    W = cfg.f0_window_d
    lmin, lmax = cfg.lag_min_d, cfg.lag_max_d
    fs = float(cfg.f0_fs_d)
    F = dp.shape[0]
    dev = dp.device

    r = dp[:, lmin: lmax + 1]                                 # [F, R]
    nxt = torch.cat([dp[:, lmin + 1: lmax + 1],
                     torch.full((F, 1), math.inf, dtype=r.dtype,
                                device=dev)], dim=1)
    ok = (r < cfg.cmnd_threshold) & (r <= nxt)
    first = _first_true(ok)
    # fallback: smallest lag within fallback_dip_margin of the global min
    dmin = torch.amin(r, dim=1, keepdim=True)
    near = (r <= dmin + cfg.fallback_dip_margin) & (r <= nxt)
    fallback = _first_true(near)
    tau_rel = torch.where(ok.any(dim=1), first, fallback)
    tau = tau_rel + lmin                                      # [F] int
    dp_tau = _pick(r, tau_rel)

    # octave-down verification: up to two octaves, frame-local
    cols_full = torch.arange(dp.shape[1], device=dev)
    for _ in range(2):
        m2 = ((cols_full[None, :] >= 2 * tau[:, None] - 2)
              & (cols_full[None, :] <= 2 * tau[:, None] + 2)
              & (cols_full[None, :] >= lmin)
              & (cols_full[None, :] <= lmax))
        dp2_masked = torch.where(m2, dp, torch.full_like(dp, math.inf))
        dp_t2 = torch.amin(dp2_masked, dim=1)
        t2 = torch.argmin(dp2_masked, dim=1)
        better = (2 * tau <= lmax) & (dp_t2 + cfg.octave_margin < dp_tau)
        tau = torch.where(better, t2, tau)
        dp_tau = torch.where(better, dp_t2, dp_tau)

    tm1 = _pick(dp, torch.clamp(tau - 1, min=0))
    tp1 = _pick(dp, torch.clamp(tau + 1, max=lmax))
    t_ref = _parabolic(tm1, dp_tau, tp1, tau, lmin, lmax, dp.dtype)
    f0 = fs / t_ref
    voiced = ((dp_tau < cfg.voicing_threshold)
              & (e0 / W >= prim.SILENCE_POWER)
              & (f0 >= cfg.f0_floor) & (f0 <= cfg.f0_ceil))
    return torch.where(voiced, f0, torch.zeros_like(f0))


def _candidates_from_cmnd(dp: torch.Tensor, e0: torch.Tensor, cfg: DspConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K CMND dip candidates per frame: (cand_f0 [F, K] Hz with 0 =
    invalid slot, emis [F, K] Viterbi emission costs)."""
    K = cfg.f0_cand_k
    W = cfg.f0_window_d
    lmin, lmax = cfg.lag_min_d, cfg.lag_max_d
    fs = float(cfg.f0_fs_d)
    F = dp.shape[0]
    dev = dp.device

    r = dp[:, lmin: lmax + 1]                                 # [F, R]
    R = r.shape[1]
    prv = dp[:, lmin - 1: lmax]                               # lmin >= 2
    nxt = torch.cat([dp[:, lmin + 1: lmax + 1],
                     torch.full((F, 1), math.inf, dtype=r.dtype,
                                device=dev)], dim=1)
    is_min = (r <= prv) & (r <= nxt)
    vals = torch.where(is_min, r, torch.full_like(r, _BIG))
    cols = torch.arange(R, device=dev)
    frame_ok = e0 / W >= prim.SILENCE_POWER
    gamma_exp = math.log2(1.0 + cfg.f0_rel_bias)

    f0s, costs, dips = [], [], []
    for _ in range(K):
        ck = torch.amin(vals, dim=1)
        ik = torch.argmin(vals, dim=1)
        vals = torch.where(cols[None, :] == ik[:, None],
                           torch.full_like(vals, _BIG), vals)
        tau = ik + lmin
        dm1 = _pick(dp, torch.clamp(tau - 1, min=0))
        dp1 = _pick(dp, torch.clamp(tau + 1, max=lmax))
        t_ref = _parabolic(dm1, ck, dp1, tau, lmin, lmax, dp.dtype)
        f0_k = fs / t_ref
        valid = ((ck < 0.5 * _BIG) & frame_ok
                 & (f0_k >= cfg.f0_floor) & (f0_k <= cfg.f0_ceil))
        oct_k = torch.log2(tau.to(dp.dtype) / float(lmin))
        cost = (ck * torch.exp2(gamma_exp * oct_k)
                + cfg.octave_margin * oct_k)
        big = torch.full_like(cost, _BIG)
        f0s.append(torch.where(valid, f0_k, torch.zeros_like(f0_k)))
        costs.append(torch.where(valid, cost, big))
        dips.append(torch.where(valid, ck, big))
    cost = torch.stack(costs, dim=1)                          # [F, K]
    dip = torch.stack(dips, dim=1)
    m = torch.amin(cost, dim=1, keepdim=True)
    dmin = torch.amin(dip, dim=1, keepdim=True)
    rel = torch.clamp(1.0 - dmin / cfg.voicing_confidence_scale, 0.0, 1.0)
    emis = torch.where(cost >= 0.5 * _BIG, torch.full_like(cost, _BIG),
                       torch.clamp((cost - m) * rel, max=cfg.f0_emis_cap))
    return torch.stack(f0s, dim=1), emis


def estimate_f0_raw(x: torch.Tensor, num_frames: int, cfg: DspConfig,
                    center_offset: int = 0) -> torch.Tensor:
    """Pre-median per-frame F0 [..., F] (0 = unvoiced) of x [..., T]:
    frame-local, so independent of where the analysis window sits (the
    streaming layer caches raw values and applies the median itself)."""
    dp, e0 = _cmnd_and_energy(x, num_frames, cfg, center_offset)
    return _select_f0_from_cmnd(dp.reshape(-1, dp.shape[-1]),
                                e0.reshape(-1), cfg).reshape(e0.shape)


def f0_candidates(x: torch.Tensor, num_frames: int, cfg: DspConfig,
                  center_offset: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cand_f0 [..., F, K] in Hz, 0 = an empty slot; emis [..., F, K] the
    Viterbi emission costs): the K deepest CMND dips per frame, refined as
    the raw estimate is (the Harvest candidate-lattice role)."""
    dp, e0 = _cmnd_and_energy(x, num_frames, cfg, center_offset)
    cand, emis = _candidates_from_cmnd(dp.reshape(-1, dp.shape[-1]),
                                       e0.reshape(-1), cfg)
    return (cand.reshape(*e0.shape, cand.shape[-1]),
            emis.reshape(*e0.shape, emis.shape[-1]))


def estimate_f0(x: torch.Tensor, num_frames: int, cfg: DspConfig,
                center_offset: int = 0) -> torch.Tensor:
    """x [T] -> f0 [F] in Hz (0 = unvoiced): the raw estimate, its 3-tap
    median, the candidate-lattice Viterbi, the voicing revision and the
    full-rate refinement on the power spectrogram (``dsp/world.analyze``'s
    F0 without the envelope stage)."""
    raw, cand_f0, cand_cost = f0_raw_and_candidates(x, num_frames, cfg,
                                                    center_offset)
    f0, choice = viterbi_snap(median3(raw), cand_f0, cand_cost, cfg)
    P = power_spectrogram(x, num_frames, cfg, center_offset)
    f0 = voicing_revision(x, f0, choice, num_frames, cfg, center_offset,
                          P=P)
    return refine_f0_from_power(P, f0, cfg)


def f0_raw_and_candidates(x: torch.Tensor, num_frames: int, cfg: DspConfig,
                          center_offset: int = 0):
    """(raw f0 [..., F], cand_f0 [..., F, K], emis [..., F, K]) from ONE
    CMND pass over x [..., T]; the per-frame search runs on all frames of
    every leading index as rows."""
    dp, e0 = _cmnd_and_energy(x, num_frames, cfg, center_offset)
    lead = e0.shape
    dp, e0 = dp.reshape(-1, dp.shape[-1]), e0.reshape(-1)
    raw = _select_f0_from_cmnd(dp, e0, cfg)
    cand, emis = _candidates_from_cmnd(dp, e0, cfg)
    return (raw.reshape(lead), cand.reshape(*lead, cand.shape[-1]),
            emis.reshape(*lead, emis.shape[-1]))


def viterbi_snap(f0: torch.Tensor, cand_f0: torch.Tensor,
                 cand_cost: torch.Tensor, cfg: DspConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounded-window Viterbi contour selection over each frame's top-K
    candidates, window [i - f0_snap_left_eff, i + f0_snap_halo]; returns
    (snapped f0 [..., F], the center's chosen candidate [..., F]).  f0
    [..., F], cand_f0 / cand_cost [..., F, K]; the windows never cross a
    leading index."""
    F = f0.shape[-1]
    K = cand_f0.shape[-1]
    lead = f0.shape[:-1]
    Hl = cfg.f0_snap_left_eff
    Hr = cfg.f0_snap_halo
    dev, dt = f0.device, f0.dtype
    ks = torch.arange(K, device=dev)
    if Hl == 0 and Hr == 0:
        k0 = torch.argmin(cand_cost, dim=-1)
        ch0 = torch.sum(torch.where(ks == k0[..., None], cand_f0,
                                    torch.zeros_like(cand_f0)), dim=-1)
        return f0, ch0
    Wn = Hl + Hr + 1
    wt = cfg.f0_trans_weight

    f0_p = Fn.pad(f0, (Hl, Hr))
    cf_p = Fn.pad(cand_f0, (0, 0, Hl, Hr))
    cc_p = Fn.pad(cand_cost, (0, 0, Hl, Hr), value=_BIG)
    nb_f = torch.stack([cf_p[..., k: k + F, :] for k in range(Wn)], dim=-2)
    nb_c = torch.stack([cc_p[..., k: k + F, :] for k in range(Wn)], dim=-2)
    nb_v = torch.stack([f0_p[..., k: k + F] for k in range(Wn)],
                       dim=-1) > 0
    act = nb_v & torch.any(nb_f > 0, dim=-1)                  # [..., F, Wn]
    lf = torch.log2(torch.clamp(nb_f, min=1e-6))              # [.., F, Wn, K]
    zero = torch.zeros((), dtype=dt, device=dev)

    def half_pass(idxs):
        """Min-plus message from the window edge into the center."""
        msg = torch.zeros((*lead, F, K), dtype=dt, device=dev)
        lfp = torch.zeros((*lead, F, K), dtype=dt, device=dev)
        has = torch.zeros((*lead, F), dtype=torch.bool, device=dev)
        for j in idxs:
            a = act[..., j]
            trans = wt * torch.abs(lf[..., j, None, :] - lfp[..., :, None])
            step = torch.amin(msg[..., :, None] + torch.where(
                has[..., None, None], trans, zero), dim=-2)  # [..., F, K]
            new = nb_c[..., j, :] + step
            msg = torch.where(a[..., None], new, msg)
            lfp = torch.where(a[..., None], lf[..., j, :], lfp)
            has = has | a
        tr = wt * torch.abs(lf[..., Hl, None, :] - lfp[..., :, None])
        return torch.amin(msg[..., :, None] + torch.where(
            has[..., None, None], tr, zero), dim=-2)         # [..., F, K]

    alpha = half_pass(range(0, Hl))
    beta = half_pass(range(Wn - 1, Hl, -1))
    total = alpha + beta + nb_c[..., Hl, :]
    k_star = torch.argmin(total, dim=-1)
    center = nb_f[..., Hl, :]
    choice = torch.sum(torch.where(ks == k_star[..., None], center,
                                   torch.zeros_like(center)), dim=-1)
    apply = (f0 > 0) & act[..., Hl] & (choice > 0)
    return torch.where(apply, choice, f0), choice


@functools.lru_cache(maxsize=None)
def _periodicity_hp_mask(fft_size: int, sample_rate: int, f0_floor: float
                         ) -> np.ndarray:
    """[K] 0/1 mask excluding bins below 0.7*f0_floor from periodicity
    evidence (a Hann-windowed DC offset leaks into bins 0..2)."""
    freqs = np.arange(fft_size // 2 + 1) * (sample_rate / fft_size)
    return (freqs >= 0.7 * f0_floor).astype(np.float64)


def _hp_mask(cfg: DspConfig, like: torch.Tensor) -> torch.Tensor:
    return dft.device_const(_periodicity_hp_mask, cfg.fft_size,
                            cfg.sample_rate, cfg.f0_floor, like=like)


def _low_band_mask(fft_size: int, sample_rate: int, low_hz: float
                   ) -> np.ndarray:
    freqs = np.arange(fft_size // 2 + 1) * (sample_rate / fft_size)
    return (freqs < low_hz).astype(np.float64)


def voicing_revision(x: torch.Tensor, f0: torch.Tensor, choice: torch.Tensor,
                     num_frames: int, cfg: DspConfig, center_offset: int,
                     P: torch.Tensor) -> torch.Tensor:
    """Full-rate band-evidence voicing revision (D4C LoveTrain role),
    frame-local given (f0, choice) [..., F] and the shared power
    spectrogram P [..., F, K] of x [..., T]:
    DEMOTE a voiced frame whose hop-aligned block window holds a
    near-silent block; RESCUE an unvoiced frame whose lattice choice shows
    high low-band periodicity with enough low-band energy."""
    N = cfg.fft_size
    fs = float(cfg.sample_rate)
    hop = cfg.hop
    M = cfg.voicing_blocks
    eb = extract_centered_frames(x, num_frames + M, hop, hop,
                                 center_offset - (M // 2) * hop + hop // 2)
    e = torch.sum((eb - torch.mean(eb, dim=-1, keepdim=True)) ** 2,
                  dim=-1)                                     # [..., F + M]
    be = torch.stack([e[..., k: k + num_frames] for k in range(M)], dim=-1)
    conf = torch.amin(be, dim=-1) / (torch.mean(be, dim=-1) + 1e-20)
    energy_ok = conf >= cfg.voicing_block_ratio

    hp = _hp_mask(cfg, P)
    w_low = dft.device_const(_low_band_mask, N, cfg.sample_rate,
                             cfg.voicing_low_band_hz, like=P) * hp
    Pl = P * w_low
    low_frac = (torch.sum(Pl, dim=-1)
                / (torch.sum(P * hp, dim=-1) + 1e-20))
    lag = torch.round(fs / torch.clamp(choice, min=1.0))
    rho = (2.0 + torch.cos(2.0 * math.pi * lag / N)) / 3.0
    r0 = dft.autocorr_at_lag(Pl, torch.zeros_like(lag), N)
    p_low = dft.autocorr_at_lag(Pl, lag, N) / (r0 + 1e-20) / rho

    rescue = ((f0 <= 0) & (choice > 0) & energy_ok
              & (p_low >= cfg.voicing_rescue_plow)
              & (low_frac >= cfg.voicing_low_frac))
    out = torch.where(rescue, choice, f0)
    return torch.where(energy_ok, out, torch.zeros_like(out))


def refine_f0_from_power(P: torch.Tensor, f0: torch.Tensor, cfg: DspConfig,
                         iters: int = 2) -> torch.Tensor:
    """Full-rate F0 refinement (StoneMask role) on the shared Hann power
    spectrogram [..., F, K]: window-ACF-corrected autocorrelation at the
    integer lags around the coarse period (row-local cosine contractions),
    subharmonic correction first, then two parabolic fits."""
    N = cfg.fft_size
    fs = float(cfg.sample_rate)
    voiced = f0 > 0
    lag = fs / torch.clamp(f0, min=1.0)
    P = P * _hp_mask(cfg, P)

    def rho(l):
        return (2.0 + torch.cos(2.0 * math.pi * l / N)) / 3.0

    r0 = dft.autocorr_at_lag(P, torch.zeros_like(lag), N) + 1e-20
    for _ in range(iters):
        l0 = torch.round(lag)
        lh = torch.round(lag / 2.0)
        ok = (lh >= cfg.lag_min) & (l0 <= cfg.lag_max)
        p_full = dft.autocorr_at_lag(P, l0, N) / (r0 * rho(l0))
        p_half = dft.autocorr_at_lag(P, lh, N) / (r0 * rho(lh))
        halve = ok & (p_half >= p_full - cfg.octave_up_margin)
        lag = torch.where(halve, lag / 2.0, lag)

    for _ in range(iters):
        l0 = torch.round(lag)
        ok = (l0 >= cfg.lag_min + 1) & (l0 <= cfg.lag_max - 1)
        a = dft.autocorr_at_lag(P, l0 - 1.0, N) / rho(l0 - 1.0)
        b = dft.autocorr_at_lag(P, l0, N) / rho(l0)
        c = dft.autocorr_at_lag(P, l0 + 1.0, N) / rho(l0 + 1.0)
        den = a - 2.0 * b + c
        safe = torch.where(den == 0, torch.ones_like(den), den)
        delta = torch.where(torch.abs(den) > 1e-12, 0.5 * (a - c) / safe,
                            torch.zeros_like(den))
        lag = torch.where(ok, l0 + torch.clamp(delta, -1.0, 1.0), lag)
    f0_new = fs / lag
    keep = voiced & (f0_new >= cfg.f0_floor) & (f0_new <= cfg.f0_ceil)
    return torch.where(keep, f0_new, f0)
