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
and returns it.  On CUDA a step is one device program
(:class:`StepProgram`, the counterpart of the JAX package's ``jax.jit(step,
donate_argnums=(0,))``, ``realtime_yukarin_tpu/training/train_step.py:308``
and ``:336``): the forward, the backward with kernel 4 inside, the clip,
AdamW (``capturable`` on CUDA, so its step counts live on the device) and
the GAN step's EMA are captured once as a CUDA graph over the state's own
tensors and replayed per step.  The gradients are the same on every run
(:func:`deterministic`): the convolutions' backward sums without atomics.

Given a :class:`~realtime_yukarin_tpu_torch.parallel.mesh.Mesh` (the
``make_sharded_*`` steps), each rank holds its rows of the global batch
(the concatenation of the data ranks' batches in rank order; every rank of
a model group holds the same rows) and its slices of the weights the shard
rule selects.  Every rank computes the global batch's loss value from
partial sums all-reduced over the data group (``training/losses.py``);
gradients are summed over the data group; a stage's clip norm sums its
split leaves' squares over the model group and counts its replicated ones
once.  AdamW, its weight decay and the GAN step's EMA act per element, so
they run on the shards unchanged.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import warnings

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
from realtime_yukarin_tpu_torch.parallel.mesh import (
    Mesh, data_parallel, gather_model, gather_params, shard_params,
    sharded_leaf_ids, sum_over_data_, sum_over_model)
from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram
from realtime_yukarin_tpu_torch.streaming.state import tree_map
from realtime_yukarin_tpu_torch.training import losses
from realtime_yukarin_tpu_torch.utils import profiling

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


def _square_norm(gs: list[torch.Tensor], split: list[bool],
                 mesh: Mesh | None) -> torch.Tensor:
    """Σ x² over a subtree's whole gradient: the model shards' squares
    summed over the model group, the replicated leaves' counted once."""
    if not any(split):
        return sum(torch.sum(x * x) for x in gs)
    parts = sum(torch.sum(x * x) for x, s in zip(gs, split) if s)
    whole = sum(torch.sum(x * x) for x, s in zip(gs, split) if not s)
    return sum_over_model(parts, mesh) + whole


def clip_per_stage(grads: dict[str, list[torch.Tensor]],
                   max_norm: float = MAX_NORM, mesh: Mesh | None = None,
                   split: dict[str, list[bool]] | None = None
                   ) -> dict[str, list[torch.Tensor]]:
    """Each top-level subtree's gradients scaled by min(1, max_norm /
    max(g, 1e-16)), g that subtree's global norm — so each stage's update
    norm depends only on its own gradients.  (``clip_grad_norm_`` divides
    by norm + 1e-6 instead, so the formula is written out.)  ``split``
    marks the leaves that are model shards of ``mesh``."""
    out = {}
    for k, gs in grads.items():
        flags = split[k] if split is not None else [False] * len(gs)
        g = torch.sqrt(_square_norm(gs, flags, mesh))
        scale = torch.clamp(max_norm / torch.clamp(g, min=1e-16), max=1.0)
        out[k] = [x * scale for x in gs]
    return out


@contextlib.contextmanager
def deterministic():
    """A step's gradients in the same order on every run: cuDNN picks each
    convolution's forward algorithm by its heuristics (no autotuning, whose
    timing-driven choice could differ between runs) for the block, and the
    convolutions' backward runs without atomics (``ops/conv.py``).  With
    cuDNN's default backward, two runs of one step parted on the H100 in
    the last bits of every convolution's weight and bias gradient, which
    Adam's per-element normalisation carried into the trained weights.
    The flag is global, so autograd's thread sees it too; a captured step
    keeps the algorithms its capture chose."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark
    cudnn.benchmark = False
    try:
        yield
    finally:
        cudnn.benchmark = saved


def optimizer_step(opt: torch.optim.Optimizer) -> None:
    """``opt.step()``, without torch's warning that a ``capturable``
    optimizer runs uncaptured: a program's warm-up and a multi-rank step
    run the captured arithmetic eagerly on purpose."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*capturable=True.*")
        opt.step()


def make_optimizer(params: dict, lr: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over every leaf of ``params`` (``f0_stats`` too: optax decays
    every leaf).  optax's b1, b2, eps and decoupled decay are torch's
    defaults; the decay is set to optax's 1e-5.  ``capturable`` on CUDA (a
    graph captures it only with its step counts on the device, which torch
    refuses for CPU tensors)."""
    leaves = [p for ps in param_leaves(params).values() for p in ps]
    return torch.optim.AdamW(leaves, lr=lr, weight_decay=WEIGHT_DECAY,
                             capturable=leaves[0].device.type == "cuda")


def gradients(loss: torch.Tensor, params: dict, mesh: Mesh | None = None
              ) -> dict[str, list[torch.Tensor]]:
    """d loss / d every leaf, grouped by top-level subtree, summed over
    ``mesh``'s data group when it splits the batch.  A leaf the loss does
    not read (``f0_stats``) gets a zero gradient, as under ``jax.grad``,
    so AdamW still decays it as optax does (torch's AdamW skips a
    parameter whose ``.grad`` is None)."""
    groups = param_leaves(params)
    flat = [p for ps in groups.values() for p in ps]
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]
    if data_parallel(mesh):
        with torch.no_grad():
            sum_over_data_(gs, mesh)
    out, i = {}, 0
    for k, ps in groups.items():
        out[k] = gs[i: i + len(ps)]
        i += len(ps)
    return out


def apply_gradients(opt: torch.optim.Optimizer, params: dict,
                    grads: dict[str, list[torch.Tensor]],
                    mesh: Mesh | None = None) -> None:
    """clip_per_stage, then one AdamW step."""
    ids = sharded_leaf_ids(params)
    split = ({k: [id(p) in ids for p in ps]
              for k, ps in param_leaves(params).items()} if ids else None)
    clipped = clip_per_stage(grads, mesh=mesh, split=split)
    for k, ps in param_leaves(params).items():
        for p, g in zip(ps, clipped[k]):
            p.grad = g
    optimizer_step(opt)
    opt.zero_grad(set_to_none=True)


def _losses(params: dict, batch: Batch, cfg: Config,
            mesh: Mesh | None = None):
    """(total, metrics, predicted envelope) of the joint objective, over
    the global batch when ``mesh`` splits it."""
    f32 = torch.float32
    # stage 1: source mc -> target mc
    mc_pred = convert_mc(params["stage1"], batch.mc_src, batch.f0_src,
                         cfg.acoustic, f32)
    l_mc = losses.mc_l1(mc_pred, batch.mc_tgt, mesh)
    # stage 2: decoded low-res envelope -> full target envelope
    env_low = decode_mcep(mc_pred, cfg.dsp)
    env_pred = refine_envelope(params["stage2"], env_low,
                               cfg.super_resolution, cfg.dsp, f32)
    l_env = losses.log_env_l2(env_pred, batch.env_tgt, mesh)
    # vocoders: self-vocoding against the real target waveform, with
    # ground-truth conditioning; each renders the whole batch at once
    wave_pred, _ = neural_vocode(params["vocoder"], batch.f0_voc,
                                 batch.env_voc, batch.ap_voc, batch.mc_voc,
                                 batch.noise, cfg.vocoder_nn, cfg.dsp)
    l_stft = losses.multi_resolution_stft(wave_pred, batch.wave_voc,
                                          mesh=mesh)
    wave_pred2, _ = waveform_vocode(params["vocoder_wave"], batch.f0_voc,
                                    batch.env_voc, batch.ap_voc,
                                    batch.mc_voc, batch.noise,
                                    cfg.vocoder_wave, cfg.dsp)
    l_wave = losses.multi_resolution_stft(wave_pred2, batch.wave_voc,
                                          mesh=mesh)
    total = l_mc + l_env + 0.5 * l_stft + 0.5 * l_wave
    metrics = {"loss": total, "mc": l_mc, "env": l_env, "stft": l_stft,
               "wave": l_wave}
    return total, {k: v.detach() for k, v in metrics.items()}, env_pred


def loss_fn(params: dict, batch: Batch, cfg: Config,
            mesh: Mesh | None = None) -> tuple[torch.Tensor, dict]:
    """(total loss, {loss, mc, env, stft, wave}) of the joint objective."""
    total, metrics, _ = _losses(params, batch, cfg, mesh)
    return total, metrics


def loss_and_grads(params: dict, batch: Batch, cfg: Config,
                   mesh: Mesh | None = None
                   ) -> tuple[dict, dict[str, list[torch.Tensor]]]:
    """(metrics, gradients by subtree) — ``jax.value_and_grad(loss_fn)``;
    with ``mesh``, the global batch's, on every rank; deterministic.
    Marks the ``forward`` and ``backward`` stages on the device."""
    with deterministic():
        profiling.mark("forward", batch.f0_src)
        total, metrics = loss_fn(params, batch, cfg, mesh)
        profiling.mark("backward", batch.f0_src)
        return metrics, gradients(total, params, mesh)


def joint_step_body(state: TrainState, batch: Batch, cfg: Config,
                    mesh: Mesh | None = None) -> dict:
    """One joint step on ``state`` in place (its host ``step`` count
    aside): the eager body that :func:`make_train_step` captures, and the
    reference its replays are held to.  Returns the metrics.  Its stages
    are marked on the device: ``forward``, ``backward``, ``optimizer``,
    ``end`` (``utils/profiling.py``)."""
    metrics, grads = loss_and_grads(state.params, batch, cfg, mesh)
    profiling.mark("optimizer", batch.f0_src)
    apply_gradients(state.opt, state.params, grads, mesh)
    profiling.mark("end", batch.f0_src)
    return metrics


def _batch_tensors(batch) -> list[torch.Tensor]:
    """A batch's tensors: a :class:`Batch`'s fields, or a tuple's items."""
    if dataclasses.is_dataclass(batch):
        return [getattr(batch, f.name) for f in dataclasses.fields(batch)]
    return list(batch)


def optimizer_leaves(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every state tensor of ``opt`` (its state made first, as
    :func:`ensure_optimizer_state` makes it), parameter by parameter."""
    ensure_optimizer_state(opt)
    return [v for group in opt.param_groups for p in group["params"]
            for v in opt.state[p].values() if isinstance(v, torch.Tensor)]


def state_leaves(state) -> tuple[torch.Tensor, ...]:
    """Every tensor a training step reads and updates in place: the
    parameter trees and modules of a state dataclass (``TrainState``,
    ``GanTrainState``, the fine-tune's) and its optimizers' moments and
    step counts."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.optim.Optimizer):
            out += optimizer_leaves(v)
        elif isinstance(v, nn.Module):
            out += list(v.parameters())
        elif isinstance(v, dict):
            out += [p for ps in param_leaves(v).values() for p in ps]
    return tuple(out)


def _eager_reason(mesh: Mesh | None) -> str | None:
    if mesh is not None and mesh.world > 1:
        return (f"{mesh.world} ranks: the step's collectives stay eager "
                f"(gloo cannot be captured; NCCL capture across cards "
                f"needs two cards)")
    return None


class StepProgram:
    """``step(state, batch) -> (state, metrics)``: ``body(state, batch)``
    (which updates ``state`` in place and returns its metrics) as one
    device program, and the host's ``state.step += 1``.

    The first call with a state (or after its tensors were replaced, or
    with a batch of another shape) copies the batch into static buffers
    and builds a :class:`CapturedProgram` over them and the state's
    tensors (:func:`state_leaves`), differentiable: on CUDA it warms the
    body up once with the whole state snapshot and put back, then
    captures it; the earlier program is dropped.  Each call copies the
    batch in and replays.  On the CPU, or with an ``eager_reason``, the
    same body runs eagerly over the same buffers.  Metrics are the
    caller's tensors.  No autograd graph over the state's parameters may be
    alive when the step is built (a kept loss or output): autograd would
    join the capture to the stream that graph ran on, and the capture
    raises."""

    def __init__(self, body, name: str, eager_reason: str | None = None):
        self._body = body
        self.name = name
        self.eager_reason = eager_reason
        self.program: CapturedProgram | None = None
        self._sig = None
        self._batch = None

    def __call__(self, state, batch):
        leaves = state_leaves(state)
        tensors = _batch_tensors(batch)
        sig = (id(state),
               tuple((t.shape, t.dtype, t.device) for t in tensors),
               tuple(t.data_ptr() for t in leaves))
        if sig != self._sig:
            self._build(state, batch, leaves)
            self._sig = sig
        with profiling.span("host.train.copy_in"):
            for dst, src in zip(_batch_tensors(self._batch), tensors):
                dst.copy_(src)
        metrics = self.program()
        state.step += 1
        return state, metrics

    def _build(self, state, batch, leaves) -> None:
        if self.program is not None and self.program.captured:
            torch.cuda.synchronize(self.program.device)  # none in flight
        self.program = None
        # the program's body holds ``state``, so its id is not reused
        static = self._batch = tree_map(torch.clone, batch)
        try:
            self.program = CapturedProgram(
                lambda: self._body(state, static), state=leaves,
                device=leaves[0].device, name=self.name,
                eager_reason=self.eager_reason, differentiable=True)
        except RuntimeError as e:
            raise RuntimeError(
                f"{self.name}: the capture failed.  If an autograd graph "
                f"over the state's parameters is still alive (a loss or an "
                f"output kept from an earlier forward), it ties their "
                f"gradients to the stream it ran on, which a capture may "
                f"not join: drop it before the step's first call") from e

    def summary(self) -> str:
        if self.program is None:
            return f"{self.name}: not built yet (built at its first call)"
        return self.program.summary()


def make_train_step(cfg: Config, mesh: Mesh | None = None) -> StepProgram:
    """step(state, batch) -> (state, metrics), updating ``state``: the
    joint step (:func:`joint_step_body`) as one device program, eager on
    a mesh of several ranks."""
    return StepProgram(functools.partial(joint_step_body, cfg=cfg,
                                         mesh=mesh),
                       "joint training step", _eager_reason(mesh))


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


def gan_losses_and_grads(state: GanTrainState, batch: Batch, cfg: Config,
                         adv_weight: float = 0.02, mesh: Mesh | None = None):
    """(metrics, generator gradients, discriminator gradients) at the
    state's generator and discriminator: the first half of the GAN step.
    Both players' losses come first (the ``forward`` stage), then both
    gradients (``backward``)."""
    disc = state.d_params
    with deterministic():
        profiling.mark("forward", batch.f0_src)
        base, metrics, env_pred = _losses(state.params, batch, cfg, mesh)
        l_adv = g_hinge_loss(disc(_log_env(env_pred)), mesh)
        ld = d_hinge_loss(disc(_log_env(batch.env_tgt)),
                          disc(_log_env(env_pred.detach())), mesh)
        profiling.mark("backward", batch.f0_src)
        g_grads = gradients(base + adv_weight * l_adv, state.params, mesh)
        d_grads = gradients(ld, {"params": disc}, mesh)
    return (dict(metrics, adv=l_adv.detach(), d_loss=ld.detach()), g_grads,
            d_grads)


def gan_step_body(state: GanTrainState, batch: Batch, cfg: Config,
                  adv_weight: float = 0.02, ema_decay: float = 0.99,
                  mesh: Mesh | None = None) -> dict:
    """One GAN step on ``state`` in place (its host ``step`` count aside):
    the eager body that :func:`make_gan_train_step` captures.  Returns the
    metrics; its stages marked as :func:`joint_step_body`'s."""
    metrics, g_grads, d_grads = gan_losses_and_grads(
        state, batch, cfg, adv_weight, mesh)
    profiling.mark("optimizer", batch.f0_src)
    apply_gradients(state.opt, state.params, g_grads, mesh)
    apply_gradients(state.d_opt, {"params": state.d_params}, d_grads, mesh)
    ema = param_leaves(state.ema_params)
    with torch.no_grad():
        for k, ps in param_leaves(state.params).items():
            for e, p in zip(ema[k], ps):
                e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
    profiling.mark("end", batch.f0_src)
    return metrics


def make_gan_train_step(cfg: Config, adv_weight: float = 0.02,
                        ema_decay: float = 0.99, mesh: Mesh | None = None):
    """step(state, batch) -> (state, metrics) with hinge-GAN on the
    predicted envelope plus the losses of :func:`loss_fn`.

    Both players' gradients are taken at the OLD generator and
    discriminator (the discriminator sees the old generator's envelope,
    detached); then both update, then the EMA generator moves to
    ``ema_decay * e + (1 - ema_decay) * p_new`` — the JAX step's order.
    Default adv_weight 0.02: the JAX package's held-out choice.  One
    device program (:class:`StepProgram`), eager on a mesh of several
    ranks."""
    return StepProgram(functools.partial(gan_step_body, cfg=cfg,
                                         adv_weight=adv_weight,
                                         ema_decay=ema_decay, mesh=mesh),
                       "GAN training step", _eager_reason(mesh))


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


# ---------------------------------------------------------------------------
# The sharded steps: the same steps over a mesh, and the states' move onto
# and off the model split
# ---------------------------------------------------------------------------

def ensure_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Create Adam's or AdamW's state for every parameter that has none
    yet, as its first step would (step 0, zero moments; the step count on
    the parameter's device when ``capturable``): every rank then holds the
    same structure, which a broadcast needs, a captured step finds every
    tensor it updates, and the first step computes the same update."""
    for group in opt.param_groups:
        for p in group["params"]:
            if not opt.state[p]:
                opt.state[p] = {
                    "step": (torch.zeros((), dtype=torch.float32,
                                         device=p.device)
                             if group["capturable"] else torch.tensor(0.0)),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}


def _moved_optimizer(opt: torch.optim.Optimizer, old: dict, new: dict,
                     convert) -> torch.optim.AdamW:
    """An AdamW like ``opt`` (made by :func:`make_optimizer`) over
    ``new``'s leaves, its state ``opt``'s with every moment of a leaf whose
    shape changed passed through ``convert``."""
    group = opt.param_groups[0]
    out = make_optimizer(new, group["lr"])
    olds = [p for ps in param_leaves(old).values() for p in ps]
    news = [p for ps in param_leaves(new).values() for p in ps]
    for p, q in zip(olds, news):
        st = opt.state.get(p)
        if st:
            out.state[q] = {k: (convert(v) if q.shape != p.shape
                                and v.shape == p.shape else v.clone())
                            for k, v in st.items()}
    return out


def _move_state(state, params_fn, convert):
    """``state`` with its generator (and EMA, discriminator) trees passed
    through ``params_fn`` and its optimizers' moments through
    ``convert``."""
    params = params_fn(state.params)
    opt = _moved_optimizer(state.opt, state.params, params, convert)
    if isinstance(state, TrainState):
        return TrainState(params=params, opt=opt, step=state.step)
    d_old = {"params": state.d_params}
    d_new = params_fn(d_old)
    return GanTrainState(
        params=params, d_params=d_new["params"], opt=opt,
        d_opt=_moved_optimizer(state.d_opt, d_old, d_new, convert),
        step=state.step, ema_params=params_fn(state.ema_params))


def shard_train_state(mesh: Mesh, state):
    """A TrainState / GanTrainState holding this rank's slices of the
    weights ``mesh`` splits, and of their AdamW moments.  ``state`` itself
    at model_parallel 1."""
    if mesh.model_parallel == 1:
        return state

    def part(v):
        n = v.shape[0] // mesh.model_parallel
        return v[mesh.model_index * n: (mesh.model_index + 1) * n].clone()
    return _move_state(state, functools.partial(shard_params, mesh), part)


def gather_train_state(mesh: Mesh, state):
    """The whole state from a sharded one (collective over the model
    group): what a checkpoint holds.  ``state`` itself at model_parallel
    1."""
    if mesh.model_parallel == 1:
        return state
    return _move_state(state, functools.partial(gather_params, mesh),
                       lambda v: gather_model(v, mesh, dim=0))


def make_sharded_train_step(cfg: Config, mesh: Mesh):
    """(step, shard_state): the joint step over ``mesh`` (each rank passes
    its local rows) and the move of an unsplit TrainState onto the model
    split.  The counterpart of the JAX package's ``make_sharded_train_step``,
    whose third value (``shard_batch``) has no work here: a rank's batch is
    already its shard."""
    return (make_train_step(cfg, mesh),
            functools.partial(shard_train_state, mesh))


def make_sharded_gan_step(cfg: Config, mesh: Mesh, adv_weight: float = 0.02,
                          ema_decay: float = 0.99):
    """(step, shard_state) for the GAN step over ``mesh``."""
    return (make_gan_train_step(cfg, adv_weight, ema_decay, mesh),
            functools.partial(shard_train_state, mesh))
