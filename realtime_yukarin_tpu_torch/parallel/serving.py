"""Batched multi-stream serving (PyTorch port of ``parallel/serving.py``).

N concurrent conversion streams advance together: the carry holds every
stream's state with a leading [N] on each leaf, and one
:func:`~realtime_yukarin_tpu_torch.streaming.pipeline.streaming_step` call
moves all of them by one chunk.  The step folds the streams into rows, so
each CUDA kernel of the path is launched once per step over all N
streams' frames (R = 20·N rows at the default chunk), never once per
stream.  Streams join and leave by resetting their lane (the silence-fill
contract); a lane whose producer has not delivered a chunk is paused by the
``live`` mask.

Several ranks (``parallel/multihost.py``, one process per GPU): the
global lanes split over the mesh's ``data`` ranks, ``num_streams`` rounded
up to their count.  Each rank holds the carries of its contiguous slot
range ``local_slots`` (the same range on every rank of a model group) and
feeds its own rows through :meth:`BatchedServer.step_local`; lane i keeps
the global lane key i.  At model_parallel 1 a step makes no collective:
the lanes are independent, as in the JAX package's data-split program.
With model_parallel M > 1 the selected weights split over the model group
and every split layer gathers its output channels there, so the step is
collective over that group, and its ranks feed the same rows (the
counterpart of the JAX rule that replicated values are passed alike).
Resets ride the in-step mask; ``step`` and ``reset_stream`` refuse at
more than one rank.

:meth:`BatchedServer.step_cost_analysis` counts one step's FLOPs and
bytes, the counterpart of the JAX method that asks XLA's cost model: the
port counts what the step dispatches (``utils/cost.py``), the same on the
CPU and on the card.  :func:`model_stage_flops` is the counterpart of
``bench.py``'s ``_model_stage_flops``: the learned stages' share of it.

The server runs the batched step as one captured device program over
static buffers (``streaming/program.py``; the counterpart of the JAX
package's ``jax.jit(step, donate_argnums=(2,))``): the carries, updated in
place, and the chunks and masks, copied in before each replay.  At
model_parallel > 1 the step stays eager: every split layer gathers over
the model group inside it, gloo cannot be captured, and NCCL capture
across cards waits for a machine with two of them.
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.acoustic import convert_mc_streamed
from realtime_yukarin_tpu_torch.models.super_resolution import \
    refine_envelope
from realtime_yukarin_tpu_torch.models.vocoder_nn import vocoder_input_dim
from realtime_yukarin_tpu_torch.models.vocoders import vocoder
from realtime_yukarin_tpu_torch.models.voice_changer import (compute_dtype,
                                                             params_to)
from realtime_yukarin_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                      shard_params)
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    init_stream, lane_noise_keys, resolve_device, streaming_step)
from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram
from realtime_yukarin_tpu_torch.streaming.state import (StreamCarry,
                                                        tree_copy_, tree_map)
from realtime_yukarin_tpu_torch.utils import cost, profiling


def _lanes(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """[N] mask shaped to broadcast over an [N, ...] leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))


def make_batched_step(cfg: Config, use_sr: bool = True,
                      vocoder_mode: str = "dsp"):
    """The batched streaming step.

    Returns step(params, init_carry, carries, chunks [N, S], keys [N, 3],
    live [N], reset [N]) -> (out [N, So], carries').  ``init_carry`` is
    one stream's carry (no leading dim); every other argument is a tensor
    on the carries' device, and the step makes no host synchronisation.

    ``reset`` puts a lane's carry back to ``init_carry`` *before* this
    tick's chunk (drop/rejoin).  ``live`` masks which lanes advance: a
    False lane keeps its carry bit for bit and emits zeros, so a stream
    whose producer has not delivered a chunk is paused instead of being
    fed silence.  Both are ``torch.where`` over every carry leaf.

    The step marks its stages on the device (``utils/profiling.py``):
    ``carry_in`` (the reset mask), the stages of :func:`streaming_step`,
    then ``carry_out`` (the live mask); the caller marks ``end`` once the
    carry is stored.
    """
    vocoder(vocoder_mode)   # an unknown mode fails here, not in the step

    def step(params, init_carry, carries, chunks, keys, live, reset):
        profiling.mark("carry_in", chunks)
        carries = tree_map(
            lambda init, c: torch.where(_lanes(reset, c), init, c),
            init_carry, carries)
        out, new = streaming_step(params, carries, chunks, keys, cfg,
                                  use_sr, vocoder_mode=vocoder_mode)
        profiling.mark("carry_out", chunks)
        kept = tree_map(
            lambda n, old: torch.where(_lanes(live, n), n, old),
            new, carries)
        return torch.where(live[:, None], out, torch.zeros_like(out)), kept

    return step


class BatchedServer:
    """Host-side N-stream server (``cuda`` unless the caller passes another
    device; no fallback).

    One rank: feed the full batch with :meth:`step` (host arrays) or
    :meth:`step_device` (device tensors).  Several ranks: each feeds the
    rows of its ``local_slots`` with :meth:`step_local` (collective over
    the model group at model_parallel > 1: every rank calls it as often).
    Lane i's noise is ``jax.random.fold_in(jax.random.key(seed), i)``'s,
    as in the JAX package.  ``reset_stream(i)`` (or a reset mask) puts lane
    i back to the stored init carry.  ``mesh`` defaults to
    ``make_mesh()``: data-parallel over every rank of the process group.
    On CUDA at model_parallel 1 the constructor captures the step
    (``program``, ``captured``): each step is one graph replay.
    """

    def __init__(self, params: dict, cfg: Config,
                 num_streams: int | None = None, use_sr: bool = True,
                 seed: int = 0, vocoder_mode: str = "dsp", device=None,
                 mesh: Mesh | None = None):
        mode, voc = vocoder_mode, vocoder(vocoder_mode)
        self.device = resolve_device(device)
        self._cfg = cfg
        self._mode, self._use_sr = mode, use_sr and voc.reads_envelope
        self.mesh = mesh if mesh is not None else make_mesh()
        if not voc.splits and self.mesh.model_parallel > 1:
            raise ValueError(f"the {mode} mode serves at model_parallel 1: "
                             "its vocoder does not split over a model group")
        dp = self.mesh.data_size
        n = -(-(num_streams or cfg.serving.num_streams) // dp) * dp
        self.num_streams = n
        lo = self.mesh.data_index * (n // dp)
        self.local_slots = range(lo, lo + n // dp)
        self._step = make_batched_step(cfg, use_sr, vocoder_mode=mode)
        self._params = shard_params(self.mesh,
                                    params_to(params, self.device))
        # the silence analysis runs once; every lane starts from it, and a
        # reset lane goes back to this stored carry (no rebuild while the
        # other lanes wait)
        with torch.no_grad():
            self._init_carry, self._geo = init_stream(
                self._params, cfg, use_sr, mode, self.device)
        nl = len(self.local_slots)
        self._carries = tree_map(
            lambda x: x.expand(nl, *x.shape).clone(), self._init_carry)
        self._keys = torch.tensor(
            lane_noise_keys(seed, n)[lo: lo + nl], dtype=torch.int64,
            device=self.device)
        # the program's static inputs
        self._chunks = torch.zeros((nl, self._geo.chunk_in_samples),
                                   device=self.device)
        self._live = torch.ones(nl, dtype=torch.bool, device=self.device)
        self._reset = torch.zeros(nl, dtype=torch.bool, device=self.device)
        self.program = CapturedProgram(
            self._program_step, self._carries, self.device,
            name=f"batched step ({nl} lanes, {mode})",
            eager_reason=None if self.mesh.model_parallel == 1 else (
                "model_parallel > 1: every split layer gathers over the "
                "model group inside the step; gloo cannot be captured and "
                "NCCL capture across cards is not verified"))

    @property
    def captured(self) -> bool:
        """Whether a step replays one CUDA graph.  False on the CPU and at
        model_parallel > 1, where the step gathers over the model group
        and stays eager."""
        return self.program.captured

    def _program_step(self) -> torch.Tensor:
        out, carries = self._step(self._params, self._init_carry,
                                  self._carries, self._chunks, self._keys,
                                  self._live, self._reset)
        tree_copy_(self._carries, carries)
        profiling.mark("end", self._chunks)
        return out

    @property
    def chunk_samples(self) -> int:
        """Input chunk size (samples at cfg.dsp.in_rate)."""
        return self._geo.chunk_in_samples

    @property
    def chunk_out_samples(self) -> int:
        """Output chunk size (samples at cfg.dsp.out_rate)."""
        return self._geo.chunk_out_samples

    @property
    def latency_samples(self) -> int:
        """End-to-end delay in OUTPUT-rate samples."""
        return self._geo.latency_out_samples(self._cfg.dsp)

    def _set_mask(self, buf: torch.Tensor, m, default: bool) -> None:
        """Copy mask ``m`` (None: all ``default``) into the static
        ``buf``."""
        if m is None:
            buf.fill_(default)
            return
        if not isinstance(m, torch.Tensor):
            m = torch.from_numpy(np.asarray(m, bool))
        if tuple(m.shape) != tuple(buf.shape):
            raise ValueError(f"mask of shape {tuple(m.shape)}, expected "
                             f"{tuple(buf.shape)}")
        buf.copy_(m)

    def _single(self, what: str) -> None:
        if self.mesh.world > 1:
            raise RuntimeError(f"{what} at {self.mesh.world} ranks: each "
                               f"rank feeds its own rows (and resets) "
                               f"through step_local()")

    def step_device(self, chunks, live=None, reset=None) -> torch.Tensor:
        """chunks [n, chunk_samples] (a tensor on the device or the host,
        or a host array: they are copied into the step's static input) ->
        converted [n, chunk_out_samples] on the device, n the lanes of
        ``local_slots`` (all N on one rank), with no host synchronisation
        when the chunks and the masks are device tensors (or the masks
        None).  ``live`` (optional [n] bool) pauses False lanes: their
        carry is kept and their output is zeros.  ``reset`` ([n] bool) puts
        a lane back to the init carry before its chunk.  The output is the
        caller's: the next step does not change it."""
        with profiling.span("host.serve.copy_in"):
            chunks = torch.as_tensor(chunks, dtype=torch.float32)
            expected = (len(self.local_slots), self.chunk_samples)
            if tuple(chunks.shape) != expected:
                raise ValueError(f"chunks of shape {tuple(chunks.shape)}, "
                                 f"expected {expected}")
            self._chunks.copy_(chunks)
            self._set_mask(self._live, live, True)
            self._set_mask(self._reset, reset, False)
        return self.program()

    def step_local(self, chunks_local: np.ndarray, live=None, reset=None
                   ) -> np.ndarray:
        """This rank's rows: chunks [n_local, chunk_samples] of global
        slots ``local_slots`` -> converted [n_local, chunk_out_samples]
        (host arrays); the masks [n_local] as in :meth:`step_device`.  One
        rank: exactly :meth:`step`."""
        out = self.step_device(chunks_local, live, reset)
        with profiling.span("host.serve.copy_out"):
            return out.cpu().numpy()

    def step(self, chunks: np.ndarray, live=None, reset=None) -> np.ndarray:
        """chunks [N, chunk_samples] -> converted [N, chunk_out_samples],
        host arrays; the masks as in :meth:`step_device`.  One rank only."""
        self._single("step()")
        return self.step_local(chunks, live, reset)

    def count_step(self) -> cost.StepCount:
        """One step of every local lane, counted (``utils/cost.py``): the
        step of :func:`make_batched_step` at the server's shapes (one chunk
        of zeros per lane, every lane live, none reset), eager, under
        ``torch.no_grad()``, on a copy of the carries.  It runs twice: the
        first run fills the device-constant caches (a capture's warm-up
        does the same), the second is counted.  The server's lanes do not
        advance and its captured program is not touched, so its next
        replay gives what it would have given without the count.  Raises
        inside a CUDA graph capture.  At model_parallel > 1 the step
        gathers over the model group, so every rank of the group calls
        this as it calls :meth:`step_local`; each counts its own lanes and
        its own shard of every split layer."""
        nl = len(self.local_slots)
        chunks = torch.zeros((nl, self.chunk_samples), device=self.device)
        live = torch.ones(nl, dtype=torch.bool, device=self.device)
        reset = torch.zeros_like(live)
        with torch.no_grad():
            for _ in range(2):
                carries = tree_map(torch.clone, self._carries)
                with cost.StepCount() as count:
                    self._step(self._params, self._init_carry, carries,
                               chunks, self._keys, live, reset)
        return count

    def step_cost_analysis(self) -> dict:
        """The cost of ONE batched step (every local lane advancing one
        chunk): ``{'flops': ..., 'bytes accessed': ...}``, the JAX method's
        keys, counted by :meth:`count_step`.

        FLOPs are the matrix products' and convolutions' at 2 per
        multiply-add (a convolution's taps on its padding included) plus
        the port's kernels by their formulas (``ops/``); XLA's cost model
        also counts elementwise ops and leaves out padded taps.  Bytes are
        every op's inputs and outputs: an unfused upper bound, where XLA
        counts a fused program.  The count is the same on the CPU and on
        the card.  Unlike the JAX method it never returns None: the port
        can always count, and an error raises.  Collective over the model
        group at model_parallel > 1 (:meth:`count_step`)."""
        count = self.count_step()
        return {"flops": float(count.flops),
                "bytes accessed": float(count.bytes)}

    def reset_stream(self, i: int) -> None:
        """Put lane i back to the stored init carry now, in place in the
        static carries; the other lanes are untouched.  One rank only."""
        self._single("reset_stream()")
        if not 0 <= i < self.num_streams:
            raise IndexError(f"stream {i} of {self.num_streams}")
        tree_map(lambda c, init: c[i].copy_(init), self._carries,
                 self._init_carry)

    def lane_carry(self, i: int) -> StreamCarry:
        """Local lane i's carry, global slot ``local_slots[i]``: views into
        the static batched carry, which the next step updates in place (as
        a donated JAX carry is consumed); clone what must outlive it."""
        return tree_map(lambda c: c[i], self._carries)


def model_stage_flops(server: BatchedServer) -> dict[str, int]:
    """FLOPs of the learned stages in one step of ``server``'s local lanes,
    each counted standalone (``utils/cost.py``) at the exact shapes the
    step gives it: {"stage1": the conv stack streamed over the Fc fresh
    frames with its per-layer caches, "stage2": super-resolution over the
    stage-1 cache frames plus Fc (0 without SR, which a mode that reads no
    envelope never runs)} and the vocoder mode's entries (its record's
    ``learned_calls``, ``models/vocoders.py``): its nets over Fc + 1 + 2 x
    its context frames, "vocoder" 0 where it has none.  Their sum is the
    learned share of :meth:`BatchedServer.step_cost_analysis`; the rest is
    structural: the analysis bases and kernels, selection one-hots, prefix
    sums, the renderer.  The counterpart of ``bench.py``'s
    ``_model_stage_flops``; at model_parallel > 1 each rank counts its
    shard of every split layer (replicated layers count on every rank),
    and every rank of the model group must call it.
    """
    cfg, geo = server._cfg, server._geo
    params, dev = server._params, server.device
    dtype = compute_dtype(cfg)
    N, Fc = len(server.local_slots), geo.chunk_frames
    dsp = cfg.dsp

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((N,) + shape, dtype=dtype, device=dev)

    def flops(fn, *args) -> int:
        with torch.no_grad(), cost.StepCount() as count:
            fn(*args)
        return count.flops

    out = {"stage1": flops(
        convert_mc_streamed, params["stage1"], zeros(Fc, dsp.mc_dim),
        zeros(Fc), server._carries.stage1_acts, cfg.acoustic, dtype)}
    out["stage2"] = flops(
        refine_envelope, params["stage2"],
        zeros(geo.stage1_cache_frames + Fc, dsp.spec_bins),
        cfg.super_resolution, dsp, dtype) if server._use_sr else 0
    voc = vocoder(server._mode)
    x = zeros(Fc + 1 + 2 * voc.context_frames(cfg), vocoder_input_dim(dsp))
    calls = voc.learned_calls(params, cfg, x, Fc + 1, dtype)
    return {**out, **{k: flops(*c) if c else 0 for k, c in calls.items()}}
