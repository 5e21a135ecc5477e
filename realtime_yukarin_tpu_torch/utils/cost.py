"""Counting the work of one step: FLOPs, bytes and the port's kernel
launches, the same on the CPU and on the card.

The JAX package asks XLA's cost model for a compiled step
(``compiled.cost_analysis()``).  The port has no compiler to ask, so it
counts what the step dispatches: :class:`StepCount` is a
``TorchDispatchMode`` that sees every aten op the step runs.

Conventions:

* **FLOPs** are those of aten's matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas: 2 per multiply-add, and a
  convolution's taps on its zero padding included.  XLA's cost model also
  counts elementwise ops (a GLU's sigmoid and product, a bias add) and
  leaves out the taps of a ``'SAME'`` convolution that fall on the
  padding, so its count of the same function differs by both
  (``tests/test_torch_cost.py`` bounds the difference).
* **The port's kernels** (the four TPU kernels' counterparts and the
  HiFi-GAN generator's fused tail, which counts no FLOPs: it is
  elementwise) report themselves by formula (:func:`kernel`, the
  ``*_cost`` functions beside each wrapper in ``ops/``): each launch
  adds its FLOPs and bytes once, whether the CUDA kernel or, on the CPU,
  the plain version computes it, and the aten ops of the plain version
  are not counted.  A ctypes launch never reaches the dispatcher, and the
  plain version's arithmetic is not the kernel's (the bank's Chebyshev
  recurrence does 6 FLOP per row, sample and harmonic), so counting the
  plain version would give the CPU one number and the card another.
* **Bytes** are the sum over every op of its input and output tensors;
  views, allocations and metadata queries count zero.  This is an unfused
  upper bound on the memory traffic: a tensor made by one op and read by
  the next counts twice.  XLA's ``bytes accessed`` is a fused program's
  and is not comparable.

A count refuses to open while the current stream is capturing a CUDA
graph: the ops of a capture are recorded, not run, and a replay runs no
Python at all.
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# ops that move no data: a fresh result reshaped, allocations, metadata
_FREE = frozenset((
    _aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten.size, _aten.sym_size,
    _aten.stride, _aten.sym_stride, _aten.numel, _aten.sym_numel, _aten.dim,
    _aten.storage_offset, _aten.sym_storage_offset, _aten.is_contiguous,
    _aten.sym_is_contiguous, _aten.is_strides_like_format,
    _aten.is_non_overlapping_and_dense, _aten.is_same_size,
    torch.ops.prim.layout, torch.ops.prim.device))


class KernelCost(NamedTuple):
    """One launch of a port kernel in a count."""
    name: str
    shape: tuple          # the launch's: (R, K), (R, H, hop[, phase])
    flops: int
    bytes: int


def _tensor_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(trees)
               if isinstance(t, torch.Tensor))


class StepCount(TorchDispatchMode):
    """Count the FLOPs and bytes of the ops run inside ``with
    StepCount() as c:`` (this thread's), and the port's kernel launches
    (``kernels``: a :class:`KernelCost` per launch, in order).
    ``op_bytes`` splits ``bytes`` by aten op (a kernel's under its name)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.op_bytes: collections.Counter = collections.Counter()
        self.kernels: list[KernelCost] = []
        self._in_kernel = 0

    def __enter__(self):
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("a cost count inside a CUDA graph capture: "
                               "the capture records the ops without running "
                               "them, and a replay runs no Python")
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        # a composite op that reaches the mode whole counts as its parts,
        # as in torch.utils.flop_counter.FlopCounterMode
        if packet not in flop_registry and packet not in _FREE:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._in_kernel:
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and packet not in _FREE:
            n = _tensor_bytes(args, kwargs, out)
            self.bytes += n
            self.op_bytes[str(packet)] += n
        return out


def _open_count() -> StepCount | None:
    """This thread's innermost open :class:`StepCount`, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, StepCount):
            return mode
    return None


@contextlib.contextmanager
def kernel(name: str, shape: tuple, flops: int, nbytes: int):
    """Around one launch of a port kernel, or its plain version on the
    CPU: in an open count, the launch adds ``flops`` and ``nbytes`` (its
    formula's) once, and the aten ops run inside the block count nothing.
    ``shape`` is the launch's, as its launcher is given it: (R, K) for the
    analysis kernels, (R, H, hop) for the bank, (R, H, hop, phase) for its
    backward, (rows, T, C, mode, y's samples a row) for the generator's
    tail.  Outside a count it does nothing."""
    count = _open_count()
    if count is None:
        yield
        return
    count.kernels.append(KernelCost(name, tuple(shape), int(flops),
                                    int(nbytes)))
    count.flops += int(flops)
    count.bytes += int(nbytes)
    count.op_bytes[name] += int(nbytes)
    count._in_kernel += 1
    try:
        yield
    finally:
        count._in_kernel -= 1
