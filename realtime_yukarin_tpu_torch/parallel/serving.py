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

One process on one GPU: there is no mesh, ``num_streams`` is taken as
given, and the JAX package's host-local feed (``step_local``,
``local_slots``) and its multi-host path are not ported yet; neither is
``step_cost_analysis`` (XLA's cost model).
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config, resolve_vocoder_mode
from realtime_yukarin_tpu_torch.models.voice_changer import params_to
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    lane_noise_keys, resolve_device, streaming_step)
from realtime_yukarin_tpu_torch.streaming.state import (StreamCarry,
                                                        StreamGeometry,
                                                        tree_map)


def _lanes(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """[N] mask shaped to broadcast over an [N, ...] leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))


def make_batched_step(cfg: Config, use_sr: bool = True,
                      use_neural_vocoder: bool = False,
                      vocoder_mode: str | None = None):
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
    """
    mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)

    def step(params, init_carry, carries, chunks, keys, live, reset):
        carries = tree_map(
            lambda init, c: torch.where(_lanes(reset, c), init, c),
            init_carry, carries)
        out, new = streaming_step(params, carries, chunks, keys, cfg,
                                  use_sr, vocoder_mode=mode)
        kept = tree_map(
            lambda n, old: torch.where(_lanes(live, n), n, old),
            new, carries)
        return torch.where(live[:, None], out, torch.zeros_like(out)), kept

    return step


class BatchedServer:
    """Host-side N-stream server on one device (``cuda`` unless the caller
    passes another; no fallback).

    Feed the full batch with :meth:`step` (host arrays) or
    :meth:`step_device` (device tensors).  Lane i's noise is
    ``jax.random.fold_in(jax.random.key(seed), i)``'s, as in the JAX
    package.  ``reset_stream(i)`` (or a reset mask passed to ``step``)
    puts lane i back to the stored init carry.
    """

    def __init__(self, params: dict, cfg: Config,
                 num_streams: int | None = None, use_sr: bool = True,
                 use_neural_vocoder: bool = False, seed: int = 0,
                 vocoder_mode: str | None = None, device=None):
        mode = resolve_vocoder_mode(use_neural_vocoder, vocoder_mode)
        self.device = resolve_device(device)
        self._cfg = cfg
        n = num_streams or cfg.serving.num_streams
        self.num_streams = n
        self._geo = StreamGeometry.from_config(cfg, use_sr,
                                               vocoder_mode=mode)
        self._step = make_batched_step(cfg, use_sr, vocoder_mode=mode)
        self._params = params_to(params, self.device)
        # the silence analysis runs once; every lane starts from it, and a
        # reset lane goes back to this stored carry (no rebuild while the
        # other lanes wait)
        with torch.no_grad():
            self._init_carry = StreamCarry.init(cfg, self._geo, self._params,
                                                self.device,
                                                vocoder_mode=mode)
        self._carries = tree_map(
            lambda x: x.expand(n, *x.shape).clone(), self._init_carry)
        self._keys = torch.tensor(lane_noise_keys(seed, n),
                                  dtype=torch.int64, device=self.device)
        self._all = torch.ones(n, dtype=torch.bool, device=self.device)
        self._none = torch.zeros(n, dtype=torch.bool, device=self.device)

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

    def _mask(self, m, default: torch.Tensor) -> torch.Tensor:
        if m is None:
            return default
        if isinstance(m, torch.Tensor):
            m = m.to(self.device, torch.bool)
        else:
            m = torch.from_numpy(np.asarray(m, bool)).to(self.device)
        if tuple(m.shape) != (self.num_streams,):
            raise ValueError(f"mask of shape {tuple(m.shape)}, expected "
                             f"({self.num_streams},)")
        return m

    def step_device(self, chunks: torch.Tensor, live=None, reset=None
                    ) -> torch.Tensor:
        """chunks [N, chunk_samples] on the device -> converted [N,
        chunk_out_samples] on the device, with no host synchronisation
        when the masks are device tensors or None.  ``live`` (optional [N]
        bool) pauses False lanes: their carry is kept and their output is
        zeros.  ``reset`` ([N] bool) puts a lane back to the init carry
        before its chunk."""
        expected = (self.num_streams, self.chunk_samples)
        if tuple(chunks.shape) != expected:
            raise ValueError(f"chunks of shape {tuple(chunks.shape)}, "
                             f"expected {expected}")
        with torch.no_grad():
            out, self._carries = self._step(
                self._params, self._init_carry, self._carries, chunks,
                self._keys, self._mask(live, self._all),
                self._mask(reset, self._none))
        return out

    def step(self, chunks: np.ndarray, live=None, reset=None) -> np.ndarray:
        """chunks [N, chunk_samples] -> converted [N, chunk_out_samples],
        host arrays; the masks as in :meth:`step_device`."""
        x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32))
        return self.step_device(x.to(self.device), live, reset).cpu().numpy()

    def reset_stream(self, i: int) -> None:
        """Put lane i back to the stored init carry now (out of place, so
        no other holder of the carries sees a change)."""
        if not 0 <= i < self.num_streams:
            raise IndexError(f"stream {i} of {self.num_streams}")
        lane = torch.arange(self.num_streams, device=self.device) == i
        self._carries = tree_map(
            lambda c, init: torch.where(_lanes(lane, c), init, c),
            self._carries, self._init_carry)

    def lane_carry(self, i: int) -> StreamCarry:
        """Lane i's carry (views into the batched carry)."""
        return tree_map(lambda c: c[i], self._carries)
