"""The joint training step and the GAN step on one device (PyTorch port of
``training/train_step.py``).

One step trains stage 1 (mc regression), stage 2 (log-envelope regression)
and both neural vocoders (multi-resolution STFT of their renders against
the real target waveform) jointly, in float32 as the JAX package's
``loss_fn`` does.  The renders are differentiated through the harmonic
bank's autograd Function, whose backward is the CUDA kernel
``csrc/harmonic_bank_bwd.cu`` on the card.  Gradients are clipped per
top-level subtree, then AdamW steps, as ``optax.chain(clip_per_stage(1.0),
optax.adamw(lr, weight_decay=1e-5))``.

PyTorch's parameters are mutable, so a step updates its state in place
and returns it.  The sharded steps of the JAX package (``make_sharded_*``)
wait for multi-GPU training.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn as nn

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp.mcep import decode_mcep
from realtime_yukarin_tpu_torch.models.acoustic import convert_mc
from realtime_yukarin_tpu_torch.models.discriminator import (
    EnvelopeDiscriminator, d_hinge_loss, g_hinge_loss)
from realtime_yukarin_tpu_torch.models.super_resolution import (
    refine_envelope)
from realtime_yukarin_tpu_torch.models.vocoder_nn import neural_vocode
from realtime_yukarin_tpu_torch.models.vocoder_wave import waveform_vocode
from realtime_yukarin_tpu_torch.models.voice_changer import (param_leaves,
                                                             params_to,
                                                             params_trainable)
from realtime_yukarin_tpu_torch.training import losses

WEIGHT_DECAY = 1e-5      # optax.adamw(lr, weight_decay=1e-5)
MAX_NORM = 1.0           # clip_per_stage(1.0)


@dataclasses.dataclass
class Batch:
    """One training batch: aligned conversion pairs + self-vocoding rows.

    Frame-major fields carry F+1 frames (the renderer's lookahead).  The
    ``*_src``/``*_tgt`` fields are the conversion pairs; the ``*_voc``
    fields are the target speaker's features on its own timeline with the
    REAL target waveform of the same window, which the vocoders train
    against."""
    f0_src: torch.Tensor       # [B, F+1]
    mc_src: torch.Tensor       # [B, F+1, M+1]
    ap_src: torch.Tensor       # [B, F+1, Bap]
    f0_tgt: torch.Tensor       # [B, F+1]  (aligned)
    mc_tgt: torch.Tensor       # [B, F+1, M+1]  (aligned)
    env_tgt: torch.Tensor      # [B, F+1, K]  (aligned)
    f0_voc: torch.Tensor       # [B, F+1]  target speaker, own timeline
    mc_voc: torch.Tensor       # [B, F+1, M+1]
    ap_voc: torch.Tensor       # [B, F+1, Bap]
    env_voc: torch.Tensor      # [B, F+1, K]
    wave_voc: torch.Tensor     # [B, F*hop] real target-speaker audio
    noise: torch.Tensor        # [B, F, k_noise, 2]

    def to(self, device) -> "Batch":
        return Batch(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


@dataclasses.dataclass
class TrainState:
    params: dict                   # trainable: params_trainable(...)
    opt: torch.optim.Optimizer
    step: int


@dataclasses.dataclass
class GanTrainState:
    params: dict                   # generator stages (trainable)
    d_params: EnvelopeDiscriminator
    opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int
    ema_params: dict               # EMA of the generator: the inference tree


def clip_per_stage(grads: dict[str, list[torch.Tensor]],
                   max_norm: float = MAX_NORM
                   ) -> dict[str, list[torch.Tensor]]:
    """Each top-level subtree's gradients scaled by min(1, max_norm /
    max(g, 1e-16)), g that subtree's global norm — so each stage's update
    norm depends only on its own gradients.  (``clip_grad_norm_`` divides
    by norm + 1e-6 instead, so the formula is written out.)"""
    out = {}
    for k, gs in grads.items():
        g = torch.sqrt(sum(torch.sum(x * x) for x in gs))
        scale = torch.clamp(max_norm / torch.clamp(g, min=1e-16), max=1.0)
        out[k] = [x * scale for x in gs]
    return out


def make_optimizer(params: dict, lr: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over every leaf of ``params`` (``f0_stats`` too: optax decays
    every leaf).  optax's b1, b2, eps and decoupled decay are torch's
    defaults; the decay is set to optax's 1e-5."""
    leaves = [p for ps in param_leaves(params).values() for p in ps]
    return torch.optim.AdamW(leaves, lr=lr, weight_decay=WEIGHT_DECAY)


def gradients(loss: torch.Tensor, params: dict
              ) -> dict[str, list[torch.Tensor]]:
    """d loss / d every leaf, grouped by top-level subtree.  A leaf the
    loss does not read (``f0_stats``) gets a zero gradient, as under
    ``jax.grad``, so AdamW still decays it as optax does (torch's AdamW
    skips a parameter whose ``.grad`` is None)."""
    groups = param_leaves(params)
    flat = [p for ps in groups.values() for p in ps]
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]
    out, i = {}, 0
    for k, ps in groups.items():
        out[k] = gs[i: i + len(ps)]
        i += len(ps)
    return out


def apply_gradients(opt: torch.optim.Optimizer, params: dict,
                    grads: dict[str, list[torch.Tensor]]) -> None:
    """clip_per_stage, then one AdamW step."""
    clipped = clip_per_stage(grads)
    for k, ps in param_leaves(params).items():
        for p, g in zip(ps, clipped[k]):
            p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _losses(params: dict, batch: Batch, cfg: Config):
    """(total, metrics, predicted envelope) of the joint objective."""
    f32 = torch.float32
    # stage 1: source mc -> target mc
    mc_pred = convert_mc(params["stage1"], batch.mc_src, batch.f0_src,
                         cfg.acoustic, f32)
    l_mc = losses.mc_l1(mc_pred, batch.mc_tgt)
    # stage 2: decoded low-res envelope -> full target envelope
    env_low = decode_mcep(mc_pred, cfg.dsp)
    env_pred = refine_envelope(params["stage2"], env_low,
                               cfg.super_resolution, cfg.dsp, f32)
    l_env = losses.log_env_l2(env_pred, batch.env_tgt)
    # vocoders: self-vocoding against the real target waveform, with
    # ground-truth conditioning; each renders the whole batch at once
    wave_pred, _ = neural_vocode(params["vocoder"], batch.f0_voc,
                                 batch.env_voc, batch.ap_voc, batch.mc_voc,
                                 batch.noise, cfg.vocoder_nn, cfg.dsp)
    l_stft = losses.multi_resolution_stft(wave_pred, batch.wave_voc)
    wave_pred2, _ = waveform_vocode(params["vocoder_wave"], batch.f0_voc,
                                    batch.env_voc, batch.ap_voc,
                                    batch.mc_voc, batch.noise,
                                    cfg.vocoder_wave, cfg.dsp)
    l_wave = losses.multi_resolution_stft(wave_pred2, batch.wave_voc)
    total = l_mc + l_env + 0.5 * l_stft + 0.5 * l_wave
    metrics = {"loss": total, "mc": l_mc, "env": l_env, "stft": l_stft,
               "wave": l_wave}
    return total, {k: v.detach() for k, v in metrics.items()}, env_pred


def loss_fn(params: dict, batch: Batch, cfg: Config
            ) -> tuple[torch.Tensor, dict]:
    """(total loss, {loss, mc, env, stft, wave}) of the joint objective."""
    total, metrics, _ = _losses(params, batch, cfg)
    return total, metrics


def loss_and_grads(params: dict, batch: Batch, cfg: Config
                   ) -> tuple[dict, dict[str, list[torch.Tensor]]]:
    """(metrics, gradients by subtree) — ``jax.value_and_grad(loss_fn)``."""
    total, metrics = loss_fn(params, batch, cfg)
    return metrics, gradients(total, params)


def make_train_step(cfg: Config):
    """step(state, batch) -> (state, metrics), updating ``state``."""
    def train_step(state: TrainState, batch: Batch):
        metrics, grads = loss_and_grads(state.params, batch, cfg)
        apply_gradients(state.opt, state.params, grads)
        state.step += 1
        return state, metrics

    return train_step


def init_train_state(params: dict, device, lr: float = 1e-4) -> TrainState:
    """A trainable copy of ``params`` on ``device`` and its optimizer."""
    params = params_trainable(params, device)
    return TrainState(params=params, opt=make_optimizer(params, lr), step=0)


# ---------------------------------------------------------------------------
# Adversarial stage-2 training: one step updates the generator (all stages,
# regression + adversarial term) and the discriminator together.
# ---------------------------------------------------------------------------

def _log_env(env: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(env, min=1e-12))


def make_gan_train_step(cfg: Config, adv_weight: float = 0.02,
                        ema_decay: float = 0.99):
    """step(state, batch) -> (state, metrics) with hinge-GAN on the
    predicted envelope plus the losses of :func:`loss_fn`.

    Both players' gradients are taken at the OLD generator and
    discriminator (the discriminator sees the old generator's envelope,
    detached); then both update, then the EMA generator moves to
    ``ema_decay * e + (1 - ema_decay) * p_new`` — the JAX step's order.
    Default adv_weight 0.02: the JAX package's held-out choice."""
    def train_step(state: GanTrainState, batch: Batch):
        disc = state.d_params
        base, metrics, env_pred = _losses(state.params, batch, cfg)
        l_adv = g_hinge_loss(disc(_log_env(env_pred)))
        g_grads = gradients(base + adv_weight * l_adv, state.params)
        d_params = {"params": disc}
        ld = d_hinge_loss(disc(_log_env(batch.env_tgt)),
                          disc(_log_env(env_pred.detach())))
        d_grads = gradients(ld, d_params)
        apply_gradients(state.opt, state.params, g_grads)
        apply_gradients(state.d_opt, d_params, d_grads)
        ema = param_leaves(state.ema_params)
        with torch.no_grad():
            for k, ps in param_leaves(state.params).items():
                for e, p in zip(ema[k], ps):
                    e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        state.step += 1
        return state, dict(metrics, adv=l_adv.detach(), d_loss=ld.detach())

    return train_step


def init_gan_train_state(params: dict, d_params: nn.Module, device,
                         lr: float = 1e-4, d_lr: float = 2e-4
                         ) -> GanTrainState:
    """Trainable copies of the generator and the discriminator on
    ``device``, their optimizers (generator lr 1e-4, discriminator 2e-4,
    as ``make_optimizer()`` / ``make_optimizer(2e-4)``), and the EMA
    generator starting at the generator."""
    params = params_trainable(params, device)
    disc = copy.deepcopy(d_params).to(device).train().requires_grad_(True)
    return GanTrainState(params=params, d_params=disc,
                         opt=make_optimizer(params, lr),
                         d_opt=make_optimizer({"params": disc}, d_lr),
                         step=0, ema_params=params_to(params, device))
