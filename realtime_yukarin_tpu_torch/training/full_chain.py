"""Full-chain quality evaluation (PyTorch port of
``training/full_chain.py``).

A held-out source WAVEFORM goes through the complete streamed, trained
pipeline (every vocoder mode), the output audio is analysed again and
scored against the target speaker's aligned features with
``training/evaluate.py``'s metrics, so a fault between stages moves a
number even when every stage passes alone.

Also here: the vocoders' conditioning mismatch (they train on
ground-truth target features but consume stage-1 / SR outputs when
serving), the fine-tune on converted features that closes it, and the
tiny-config training recipe of the held-out gates and
``tools/torch_quality.py``.  Every entry point runs on ``device``
(``cuda`` unless the caller names another).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import pathlib

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature
from realtime_yukarin_tpu_torch.models.vocoder_nn import neural_vocode
from realtime_yukarin_tpu_torch.models.vocoder_wave import waveform_vocode
from realtime_yukarin_tpu_torch.models.vocoders import vocoder
from realtime_yukarin_tpu_torch.models.voice_changer import (
    convert_features, params_to)
from realtime_yukarin_tpu_torch.pipeline import (extend_one_frame,
                                                offline_analyze)
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    frame_noise, noise_key_from_seed, resolve_device)
from realtime_yukarin_tpu_torch.streaming.state import (StreamGeometry,
                                                        noise_bins)
from realtime_yukarin_tpu_torch.training import evaluate, losses
from realtime_yukarin_tpu_torch.training.align import dtw_path
from realtime_yukarin_tpu_torch.training.dataset import crop_rows
from realtime_yukarin_tpu_torch.training.train_step import (
    StepProgram, deterministic, gradients, optimizer_step)

VOCODERS = ("vocoder", "vocoder_wave")
FINETUNE_MAX_NORM = 1.0     # optax.clip_by_global_norm(1.0)


def _on(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def stream_convert(params: dict, cfg: Config, wave: np.ndarray,
                   use_sr: bool = True, vocoder_mode: str = "dsp",
                   seed: int = 0, device=None) -> np.ndarray:
    """Push ``wave`` through the streaming path chunk by chunk and return
    the converted audio on the input timeline (latency removed)."""
    from realtime_yukarin_tpu_torch.streaming.stream import (
        VoiceChangerStream)

    stream = VoiceChangerStream(params, cfg, use_sr, seed=seed,
                                vocoder_mode=vocoder_mode, device=device)
    S = stream.chunk_samples
    x = np.asarray(wave, np.float32)
    pad = (-len(x)) % S
    if pad:
        x = np.concatenate([x, np.zeros(pad, np.float32)])
    outs = []
    for k in range(len(x) // S):
        stream.add(x[k * S: (k + 1) * S])
        outs.append(stream.process())
    outs.append(stream.flush())
    y = np.concatenate(outs)
    lat = stream.latency_samples
    return y[lat: lat + len(wave)]


def full_chain_metrics(params: dict, cfg: Config, src_wave: np.ndarray,
                       ho: dict, modes=("dsp", "ddsp", "wave"),
                       use_sr: bool = True, seed: int = 0,
                       device=None) -> dict:
    """Convert a held-out source waveform through the streamed pipeline
    per vocoder mode, analyse the output audio again, and score it
    against the aligned target features (``ho``: the prepared npz dict,
    f0_tgt / mc_tgt on the source timeline).

    Returns {mode: {mcd_db, logf0_rmse, vuv_error}}.  The MCD includes
    the render and analysis round trip: comparable across parameter
    trees, not a pure stage-1 number."""
    device = resolve_device(device)
    hop = cfg.dsp.hop
    f0_tgt = _on(ho["f0_tgt"], device)
    mc_tgt = _on(ho["mc_tgt"], device)
    F_ho = int(f0_tgt.shape[0])
    out = {}
    for mode in modes:
        geo = StreamGeometry.from_config(cfg, use_sr, vocoder_mode=mode)
        trim = geo.model_ctx + 4
        y = stream_convert(params, cfg, src_wave, use_sr, mode, seed,
                           device)
        F = len(y) // hop
        feat = offline_analyze(y[: F * hop], cfg, F, device)
        sl = slice(trim, min(F, F_ho) - trim)
        f0m = evaluate.f0_metrics(feat.f0[sl], f0_tgt[sl])
        out[mode] = {
            "mcd_db": float(evaluate.mcd_db(feat.mc[sl], mc_tgt[sl])),
            "logf0_rmse": float(f0m["logf0_rmse"]),
            "vuv_error": float(f0m["vuv_error"]),
        }
    return out


# ---------------------------------------------------------------------------
# Vocoder conditioning mismatch (train on ground truth, infer on converted)
# ---------------------------------------------------------------------------

def _converted_on_target_timeline(params: dict, cfg: Config, d: dict,
                                  device) -> AcousticFeature:
    """Converted features (stage 1 -> SR from the SOURCE utterance)
    warped onto the TARGET's own timeline, where the real waveform lives.

    The DTW path target frame -> source frame turns (converted features,
    real target audio) into a pair.  F0 stays the target's real contour,
    so only the mismatch in the features the vocoder nets read is
    measured."""
    src = AcousticFeature(f0=_on(d["f0_src"], device),
                          env=_on(d["env_src"], device),
                          ap=_on(d["ap_src"], device),
                          mc=_on(d["mc_src"], device))
    with torch.no_grad():
        conv = convert_features(params, src, cfg)
    idx = dtw_path(_on(d["mc_voc"], device)[:, 1:], src.mc[:, 1:])
    return AcousticFeature(f0=_on(d["f0_voc"], device),
                           env=conv.env[idx], ap=src.ap[idx],
                           mc=conv.mc[idx])


def conditioning_gap(params: dict, cfg: Config, ho: dict, seed: int = 11,
                     device=None) -> dict:
    """Each neural vocoder's loss against the real target waveform when
    conditioned on CONVERTED features instead of the ground-truth ones it
    trained on.  The noise is the JAX package's ``jax.random.key(seed)``
    frame noise.

    Returns {mode: {gt, converted, ratio}} (multi-resolution STFT losses;
    ratio > 1 is the mismatch's cost)."""
    device = resolve_device(device)
    params = params_to(params, device)
    wave_real = _on(ho["wave_voc"], device)
    Fv = int(ho["f0_voc"].shape[0])
    noise = frame_noise(noise_key_from_seed(seed), 0, Fv, noise_bins(cfg),
                        like=wave_real)
    gt = AcousticFeature(f0=_on(ho["f0_voc"], device),
                         env=_on(ho["env_voc"], device),
                         ap=_on(ho["ap_voc"], device),
                         mc=_on(ho["mc_voc"], device))
    cw = _converted_on_target_timeline(params, cfg, ho, device)
    feats = [extend_one_frame(f) for f in (gt, cw)]
    out = {}
    with torch.no_grad():
        for mode in ("ddsp", "wave"):
            a, c = (float(losses.multi_resolution_stft(vocoder(mode).offline(
                params, cfg, f, lambda: noise, torch.float32), wave_real))
                for f in feats)
            out[mode] = {"gt": a, "converted": c, "ratio": c / a}
    return out


def converted_pairs(params: dict, cfg: Config, prep_dir,
                    device=None) -> list[dict]:
    """The fine-tune-on-converted dataset of a prepared corpus dir: per
    utterance, the converted features warped onto the target timeline and
    the real target waveform (host arrays)."""
    device = resolve_device(device)
    params = params_to(params, device)
    pairs = []
    for p in sorted(pathlib.Path(prep_dir).glob("*.npz")):
        if p.name.startswith("stats_"):
            continue
        with np.load(p) as z:
            d = dict(z)
        cw = _converted_on_target_timeline(params, cfg, d, device)
        pairs.append({"f0": cw.f0.cpu().numpy(), "env": cw.env.cpu().numpy(),
                      "ap": cw.ap.cpu().numpy(), "mc": cw.mc.cpu().numpy(),
                      "wave": d["wave_voc"]})
    return pairs


def finetune_batches(pairs: list[dict], hop: int, k_noise: int,
                     crop_frames: int, batch_size: int,
                     rng: np.random.Generator):
    """One fine-tune batch (f0, env, ap, mc, wave, noise) of host arrays,
    drawn as the JAX package draws it.  A window past an utterance's end
    is edge-padded (``crop_rows``), where the JAX package's
    ``np.stack`` raises on the short rows."""
    rows = {k: [] for k in ("f0", "env", "ap", "mc")}
    waves = []
    for _ in range(batch_size):
        d = pairs[int(rng.integers(len(pairs)))]
        F = d["f0"].shape[0]
        o = int(rng.integers(max(F - crop_frames, 1)))
        for k in rows:
            rows[k].append(crop_rows(d[k], o, crop_frames + 1))
        waves.append(crop_rows(d["wave"].reshape(-1, hop), o,
                               crop_frames).reshape(-1))
    noise = rng.standard_normal(
        (batch_size, crop_frames, k_noise, 2)).astype(np.float32)
    return tuple(np.stack(rows[k]).astype(np.float32)
                 for k in ("f0", "env", "ap", "mc")) + (
        np.stack(waves).astype(np.float32), noise)


def finetune_loss(voc: dict, batch: tuple, cfg: Config) -> torch.Tensor:
    """Both neural vocoders' multi-resolution STFT losses on one batch,
    each rendered once over the whole [B, ...] batch."""
    f0, env, ap, mc, wave, noise = batch
    w1, _ = neural_vocode(voc["vocoder"], f0, env, ap, mc, noise,
                          cfg.vocoder_nn, cfg.dsp)
    w2, _ = waveform_vocode(voc["vocoder_wave"], f0, env, ap, mc, noise,
                            cfg.vocoder_wave, cfg.dsp)
    return (losses.multi_resolution_stft(w1, wave)
            + losses.multi_resolution_stft(w2, wave))


def make_finetune_optimizer(leaves: list[torch.Tensor], lr: float
                            ) -> torch.optim.Adam:
    """Plain Adam (optax's b1, b2, eps; no weight decay) over ``leaves``,
    ``capturable`` on CUDA (its step counts on the device)."""
    return torch.optim.Adam(leaves, lr=lr,
                            capturable=leaves[0].device.type == "cuda")


def finetune_step(opt: torch.optim.Optimizer, leaves: list[torch.Tensor],
                  grads: list[torch.Tensor]) -> None:
    """One fine-tune update: the gradients of all leaves scaled together
    by ``optax.clip_by_global_norm(1.0)``'s rule (unchanged below a
    global norm of 1, else g / norm), then one Adam step."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < FINETUNE_MAX_NORM
    for p, g in zip(leaves, grads):
        p.grad = torch.where(keep, g, g / norm * FINETUNE_MAX_NORM)
    optimizer_step(opt)
    opt.zero_grad(set_to_none=True)


@dataclasses.dataclass
class FinetuneState:
    voc: dict                      # the two vocoder subtrees (trainable)
    opt: torch.optim.Optimizer     # make_finetune_optimizer over voc
    step: int = 0


def vocoder_leaves(voc: dict) -> list[torch.Tensor]:
    """Both vocoders' parameters, in the fine-tune optimizer's order."""
    return [p for k in VOCODERS for p in voc[k].parameters()]


def finetune_step_body(state: FinetuneState, batch: tuple, cfg: Config
                       ) -> dict:
    """One fine-tune step on ``state`` in place: the loss's gradients
    (deterministic), the global-norm clip and Adam.  The eager body
    :func:`make_finetune_step` captures.  Returns {"loss": ...}."""
    with deterministic():
        loss = finetune_loss(state.voc, batch, cfg)
        grads = gradients(loss, state.voc)
    finetune_step(state.opt, vocoder_leaves(state.voc),
                  [g for k in VOCODERS for g in grads[k]])
    return {"loss": loss.detach()}


def make_finetune_step(cfg: Config) -> StepProgram:
    """step(state, batch) -> (state, metrics) for the fine-tune: one
    device program on CUDA (the counterpart of the JAX package's jitted
    ``step``, ``realtime_yukarin_tpu/training/full_chain.py:252``)."""
    return StepProgram(functools.partial(finetune_step_body, cfg=cfg),
                       "vocoder fine-tune step")


def finetune_vocoder_on_converted(params: dict, cfg: Config,
                                  pairs: list[dict], steps: int = 200,
                                  lr: float = 3e-4, crop_frames: int = 16,
                                  batch_size: int = 8, seed: int = 0,
                                  device=None) -> dict:
    """Fine-tune ONLY the two vocoder subtrees on (converted features,
    real waveform) pairs; the conversion stages and ``f0_stats`` stay as
    they are.

    The optimizer is the JAX package's ``optax.chain(
    clip_by_global_norm(1.0), adam(lr))`` over both vocoders together:
    plain Adam, no weight decay, one clip over the global norm (not the
    trainer's per-stage clip and AdamW).  Returns a new params tree on
    ``device``; the caller's is left as it is."""
    device = resolve_device(device)
    hop = cfg.dsp.hop
    k_noise = prim.noise_fft_size(hop) // 2 + 1
    rng = np.random.default_rng(seed)
    voc = {k: copy.deepcopy(params[k]).to(device).train().requires_grad_(True)
           for k in VOCODERS}
    state = FinetuneState(voc, make_finetune_optimizer(vocoder_leaves(voc),
                                                       lr))
    step = make_finetune_step(cfg)
    for _ in range(steps):
        batch = tuple(_on(a, device) for a in finetune_batches(
            pairs, hop, k_noise, crop_frames, batch_size, rng))
        state, _ = step(state, batch)
    return params_to(dict(params, **voc), device)


# ---------------------------------------------------------------------------
# The shared training recipe (tests and tools/torch_quality.py)
# ---------------------------------------------------------------------------

def train_plain(cfg: Config, prep_dir, steps: int = 600, lr: float = 1e-3,
                batch_size: int = 8, crop_frames: int = 16, seed: int = 0,
                init_key: int = 0, device=None):
    """The deterministic tiny-config training recipe of the held-out
    gates: the plain joint objective on the prepared corpus, from
    ``init_params(cfg, torch.Generator().manual_seed(init_key))``.
    Returns (initial params, trained params) on ``device``."""
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    from realtime_yukarin_tpu_torch.training.dataset import CorpusDataset
    from realtime_yukarin_tpu_torch.training.train_step import (
        init_train_state, make_train_step)

    device = resolve_device(device)
    params = init_params(cfg, torch.Generator().manual_seed(init_key),
                         device)
    state = init_train_state(params, device, lr)
    step = make_train_step(cfg)
    ds = CorpusDataset(str(prep_dir), cfg, crop_frames=crop_frames,
                       seed=seed, device=device)
    for _ in range(steps):
        state, _m = step(state, ds.sample_batch(batch_size))
    return params, params_to(state.params, device)
