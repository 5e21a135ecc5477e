"""The streaming step with the BigVGAN v2 generator as its synthesis stage,
in plain PyTorch: the reference of the program's ``"bigvgan"`` vocoder
mode, and lanes stepped side by side over it (:func:`replay`).

Analysis, stage 1 and the F0 transform are the reference's own (the body
of ``streaming/pipeline.py:streaming_step`` up to its synthesis stage,
copied here as ``streaming/hifigan.py`` copies it), over a geometry whose
model halo holds the generator's receptive field where SR's would be
(:func:`geometry`).  The generator (``models/vocoder_bigvgan.py``) reads
one conditioning row per aligned pair of frames, the mean of the two: a
row gives 240 samples, two hops of 120 (the departure its docstring
notes).  So the pairs lie on the global frame grid: the chunk is whole
pairs, the halo is whole pairs (twice the generator's reach in rows), and
the delay D is made even by one more frame of model halo where it is odd.
Each step runs the generator over the pairs of the Fc + 1 + 2·halo frames
of the vocoders' conditioning (the last, unpaired frame unread) and keeps
the centre Fc·hop samples.  The generator keeps no state across chunks:
its halo is recomputed.

The configuration's ``vocoder_bigvgan`` section, which the reference's
``Config`` does not take, is split off by :func:`split_config`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.dsp.envelope import power_spectrogram
from benchmark.reference.dsp.f0 import (f0_raw_and_candidates, viterbi_snap,
                                        voicing_revision)
from benchmark.reference.dsp.framing import median3
from benchmark.reference.dsp.resample import resample_chunk
from benchmark.reference.dsp.world import analyze_given_f0
from benchmark.reference.models.acoustic import convert_mc_streamed
from benchmark.reference.models.vocoder_bigvgan import BigVGANConfig
from benchmark.reference.models.vocoder_nn import vocoder_inputs
from benchmark.reference.models.voice_changer import (compute_dtype,
                                                      convert_f0_stats)
from benchmark.reference.streaming.hifigan import init_carry
from benchmark.reference.streaming.state import (StreamCarry,
                                                 StreamGeometry, input_plan,
                                                 output_plan, tree_map)

PORT_ONLY = ("vocoder_hifigan", "vocoder_hifigan_params_path",
             "vocoder_bigvgan", "vocoder_bigvgan_params_path")
PAIR = 2            # frames a conditioning row: 240 samples / hop 120


def split_config(d: dict) -> tuple[dict, BigVGANConfig]:
    """(the configuration dict the reference ``Config`` takes, the
    generator's layer list): the port-only keys taken out and the mode set
    to the reference's dsp, whose analysis and models the step runs."""
    ref = {k: v for k, v in d.items() if k not in PORT_ONLY}
    ref["vocoder_mode"] = "dsp"
    return ref, BigVGANConfig(**d.get("vocoder_bigvgan", {}))


def halo_frames(bcfg: BigVGANConfig) -> int:
    """The generator's halo in frames: its reach in rows, two frames a
    row."""
    return PAIR * bcfg.halo_rows


def geometry(cfg: Config, bcfg: BigVGANConfig) -> StreamGeometry:
    """``StreamGeometry.from_config``'s arithmetic without SR, with the
    generator's halo in the model halo and D even (one frame more of halo
    where it would be odd), so that every step's window starts on a
    pair."""
    dsp = cfg.dsp
    hop = dsp.hop
    Fc = cfg.streaming.chunk_frames(dsp)
    if Fc % PAIR or bcfg.row_samples != PAIR * hop:
        raise ValueError(f"{Fc} frames a chunk, {bcfg.row_samples} samples "
                         f"a row: not whole pairs of frames of {hop}")
    E = dsp.f0_edge_frames
    mctx = cfg.acoustic.context_frames + E + halo_frames(bcfg)
    AH = max(dsp.fft_size // 2, (dsp.f0_frame_len + 1) // 2,
             (dsp.voicing_energy_win + 1) // 2)
    ah_frames = -(-AH // hop)
    mctx += (mctx + ah_frames) % PAIR
    p_in = input_plan(dsp, Fc * hop)
    p_out = output_plan(dsp, Fc * hop)
    return StreamGeometry(
        chunk_frames=Fc, chunk_samples=Fc * hop,
        chunk_in_samples=p_in.chunk_in, chunk_out_samples=p_out.chunk_out,
        model_ctx=mctx, analysis_half=AH, delay_frames=mctx + ah_frames,
        analysis_frames=Fc + 2 * mctx + 1,
        buf_samples=(Fc + 2 * mctx + ah_frames) * hop + AH,
        buf_frame0_offset=AH, in_delay=p_in.delay_out,
        out_delay=p_out.delay_out, stage1_ctx=cfg.acoustic.context_frames,
        f0_edge=E, f0_left=dsp.f0_left_frames)


def pairs(x: torch.Tensor) -> torch.Tensor:
    """Conditioning rows [..., T // 2, D] of frames [..., T, D]: each row
    the mean of frames 2j and 2j + 1 (an odd last frame unread)."""
    n = x.shape[-2] // PAIR * PAIR
    return (x[..., 0: n: 2, :] + x[..., 1: n: 2, :]) / 2


def streaming_step(params: dict, carry: StreamCarry, chunk: torch.Tensor,
                   cfg: Config, bcfg: BigVGANConfig
                   ) -> tuple[torch.Tensor, StreamCarry]:
    """One chunk in, one chunk out, for one stream or [N] of them
    (``params["vocoder_bigvgan"]`` the :class:`Generator`)."""
    geo = geometry(cfg, bcfg)
    dsp = cfg.dsp
    hop = dsp.hop
    Fc = geo.chunk_frames
    mctx = geo.model_ctx

    chunk, rs_in = resample_chunk(carry.rs_in, chunk.to(carry.wave_buf),
                                  input_plan(dsp, geo.chunk_samples))
    buf = torch.cat([carry.wave_buf[..., geo.chunk_samples:], chunk],
                    dim=-1)

    C = geo.cache_frames
    E = geo.f0_edge
    El = geo.f0_left
    off = geo.buf_frame0_offset + C * hop
    raw_fresh, cand_fresh, cost_fresh = f0_raw_and_candidates(
        buf, geo.fresh_frames, dsp, off)
    raw_ext = torch.cat([carry.f0_raw_prev, raw_fresh], dim=-1)
    cand_ext = torch.cat([carry.f0_cand_prev, cand_fresh], dim=-2)
    cost_ext = torch.cat([carry.f0_cost_prev, cost_fresh], dim=-2)
    m_ext = median3(raw_ext)
    hl = dsp.f0_snap_left_eff
    hr = dsp.f0_snap_halo
    lo = El - hl
    win = slice(lo, lo + Fc + hl + hr)
    snapped, choice = viterbi_snap(m_ext[..., win], cand_ext[..., win, :],
                                   cost_ext[..., win, :], dsp)
    P = power_spectrogram(buf, Fc, dsp, off)
    f0_final = voicing_revision(buf, snapped[..., hl: hl + Fc],
                                choice[..., hl: hl + Fc], Fc, dsp, off, P=P)
    ffresh = analyze_given_f0(buf, f0_final, Fc, dsp, off, refine=True, P=P)

    f0_all = torch.cat([carry.f0_cache, ffresh.f0], dim=-1)
    mc_all = torch.cat([carry.mc_cache, ffresh.mc], dim=-2)
    ap_all = torch.cat([carry.ap_cache, ffresh.ap], dim=-2)

    ctx_v = halo_frames(bcfg)
    c1 = cfg.acoustic.context_frames
    dtype = compute_dtype(cfg)
    Fn = geo.analysis_frames
    L = Fc + 1
    Lv = L + 2 * ctx_v
    s = mctx - ctx_v
    res, stage1_acts = convert_mc_streamed(
        params["stage1"], mc_all[..., Fn - E - Fc: Fn - E, :],
        f0_all[..., Fn - E - Fc: Fn - E], carry.stage1_acts, cfg.acoustic,
        dtype)
    mc_c_fresh = mc_all[..., Fn - E - c1 - Fc: Fn - E - c1, :] + res
    mc_c_need = torch.cat([carry.mc_c_cache, mc_c_fresh], dim=-2)
    f0c_need = convert_f0_stats(f0_all[..., c1 + E: Fn - c1 - E],
                                params["f0_stats"])
    # the needed arrays start at frame c1 + E; frame s is the window's
    # first
    a = s - c1 - E
    f0v, mcv = f0c_need[..., a: a + Lv], mc_c_need[..., a: a + Lv, :]
    apv = ap_all[..., s: s + Lv, :]

    # the generator over the window's pairs; the centre Fc frames' samples
    x = pairs(vocoder_inputs(f0v, mcv, apv))
    lead = x.shape[:-2]
    y = params["vocoder_bigvgan"](x.reshape(-1, *x.shape[-2:]), dtype)
    out = y.reshape(*lead, -1)[..., ctx_v * hop: (ctx_v + Fc) * hop]

    out, rs_out = resample_chunk(carry.rs_out, out,
                                 output_plan(dsp, geo.chunk_samples))
    new_carry = StreamCarry(
        wave_buf=buf, synth=None, frame_pos=carry.frame_pos + Fc,
        mc_c_cache=mc_c_need[..., Fc:, :], stage1_acts=stage1_acts,
        f0_cache=f0_all[..., Fc:], mc_cache=mc_all[..., Fc:, :],
        ap_cache=ap_all[..., Fc:, :],
        f0_raw_prev=raw_ext[..., Fc: Fc + El],
        f0_cand_prev=cand_ext[..., Fc: Fc + El, :],
        f0_cost_prev=cost_ext[..., Fc: Fc + El, :],
        rs_in=rs_in, rs_out=rs_out)
    return out, new_carry


def replay(params: dict, cfg: Config, bcfg: BigVGANConfig,
           chunks: np.ndarray, live: np.ndarray, device) -> np.ndarray:
    """``lanes.replay`` over this step: K streams through T ticks from
    silence; chunks [T, K, S], live [T, K] (a stream that does not advance
    keeps its state and emits zeros).  The generator draws no noise, so
    there are no keys.  Returns [T, K, chunk_out_samples] on the host."""
    T, K = live.shape
    geo = geometry(cfg, bcfg)
    with torch.no_grad():
        init = init_carry(params, cfg, geo, device)
        carries = tree_map(lambda x: x.expand(K, *x.shape).clone(), init)
        x_all = torch.as_tensor(chunks, dtype=torch.float32, device=device)
        live_all = torch.as_tensor(live, device=device)
        out = torch.zeros((T, K, geo.chunk_out_samples), device=device)
        for t in np.flatnonzero(live.any(axis=1)):
            m = live_all[t]
            y, new = streaming_step(params, carries, x_all[t], cfg, bcfg)
            carries = tree_map(
                lambda n, o: torch.where(
                    m.reshape(m.shape + (1,) * (n.ndim - 1)), n, o),
                new, carries)
            out[t] = torch.where(m[:, None], y, 0.0)
        return out.cpu().numpy()
