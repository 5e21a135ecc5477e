"""One device program per chunk: the port's counterpart of ``jax.jit``
with a donated carry.

The JAX package runs each step as one compiled program whose carry is
donated, so XLA updates it in place: the streaming step
(``realtime_yukarin_tpu/streaming/pipeline.py:1-8``, ``:259-262``:
``jax.jit(..., donate_argnames=("carry",))``), the batched step
(``realtime_yukarin_tpu/parallel/serving.py:79``: ``jax.jit(step,
donate_argnums=(2,))``), offline conversion, analysis and synthesis
(``realtime_yukarin_tpu/pipeline.py:44``, ``:72``, ``:97``, ``:103``:
jitted per static ``num_frames``) and the training steps
(``realtime_yukarin_tpu/training/train_step.py:308``, ``:336``:
``jax.jit(step, donate_argnums=(0,))``).  Here a :class:`CapturedProgram`
runs a body over static buffers: the inputs the caller copies in before
each call, the state (carry, or a training state's parameters and
optimizer moments) the body updates in place, and the output the body
returns.  On CUDA the body is captured once as a ``torch.cuda.CUDAGraph``,
so a call is one graph launch instead of ~1200 kernel launches; on the CPU
the same body runs eagerly over the same buffers.  A training body
differentiates (``differentiable=True``): its forward, its backward (run
by autograd on its own thread, on the capturing stream) and its optimizer
steps are captured together.  A capture that fails raises: nothing falls
back to eager execution on CUDA.
"""

from __future__ import annotations

import gc
import time

import torch

from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.streaming.state import (snapshot, tree_copy_,
                                                        tree_map)
from realtime_yukarin_tpu_torch.utils import profiling


def _pool_bytes(pool) -> int:
    """Bytes the caching allocator reserved for the graph pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class CapturedProgram:
    """``body()`` as one device program over static buffers.

    ``body`` takes no arguments: it reads the static input tensors and the
    ``state`` tree, updates ``state`` in place (``tree_copy_``, or a
    training step's in-place optimizer update) and returns its output: a
    tensor, or a tuple, dict or dataclass of them.  On CUDA, unless the
    caller gives an ``eager_reason`` (why the body cannot be captured), the
    constructor builds the kernels, warms the body up (:meth:`warm_up`:
    one call fills the host-constant caches and the kernel plans), then
    captures it into a private memory pool, under ``torch.no_grad()``
    unless the body is ``differentiable``.  The warm-up and the capture run
    on the real state, so it is snapshot first and put back after each.
    Each call then replays the graph on the current stream, counts the
    kernels the capture launched (``ops/cuda.py``) and returns a clone of
    the output, which the caller owns, as JAX returns fresh arrays.
    Otherwise a call runs the body eagerly, under ``no_grad`` unless it is
    ``differentiable``.
    """

    def __init__(self, body, state=None, device="cpu", name: str = "",
                 eager_reason: str | None = None,
                 differentiable: bool = False):
        self._body = body
        self.state = state
        self.device = torch.device(device)
        self.name = name
        self.eager_reason = eager_reason
        self.differentiable = differentiable
        self.capture_s = 0.0       # warm-up plus capture, seconds
        self.pool_bytes = 0        # the graph's private pool
        self._graph = None
        self._capture = None
        self._out = None
        if self.device.type != "cuda":
            self.eager_reason = "CUDA graphs need a GPU"
        elif eager_reason is None:
            self._capture_graph()

    @property
    def captured(self) -> bool:
        """Whether calls replay a CUDA graph (False: the body runs
        eagerly)."""
        return self._graph is not None

    @property
    def kernel_launches(self) -> dict[str, int]:
        """{kernel name: launches per replay} of the port's kernels, by
        the kernel each launch computes (``CudaKernel.computes``: either
        design of the power spectrum counts as ``power_spectrum``)."""
        counts: dict[str, int] = {}
        for kernel, _ in (self._capture.launches if self._capture else ()):
            counts[kernel.computes] = counts.get(kernel.computes, 0) + 1
        return counts

    def _grad_mode(self):
        return (torch.enable_grad() if self.differentiable
                else torch.no_grad())

    def _restore(self, saved) -> None:
        with torch.no_grad():            # parameters are leaves
            tree_copy_(self.state, saved)

    def warm_up(self):
        """Run the body once on the real state, then put the state back: a
        snapshot is taken first, so ``frame_pos`` and the caches (or a
        training state's parameters, moments and step counts) have not
        moved on when the capture begins.  The call fills the
        host-constant caches and the kernel plans, so the capture neither
        allocates a constant nor copies from the host; the capture itself
        refuses a host sync or a pageable copy
        (``capture_error_mode="thread_local"``).  On CUDA the call runs on
        a side stream.  Returns the snapshot."""
        with torch.no_grad():
            saved = snapshot(self.state)
        with self._grad_mode():
            if self.device.type != "cuda":
                self._body()
            else:
                main = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    self._body()
                main.wait_stream(side)
        self._restore(saved)
        return saved

    def _capture_graph(self) -> None:
        t0 = time.perf_counter()
        cuda.build()                    # nvcc runs before any capture
        saved = self.warm_up()
        pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.device)
        # a program's body refers back to its owner, so a dropped stream or
        # server is freed by the cyclic collector, which must not destroy
        # its graph in the middle of this capture (that invalidates it)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self._grad_mode(), \
                    cuda.capturing(side.cuda_stream) as capture, \
                    torch.cuda.graph(graph, pool=pool, stream=side,
                                     capture_error_mode="thread_local"):
                out = self._body()
        finally:
            if collecting:
                gc.enable()
        self._restore(saved)
        torch.cuda.synchronize(self.device)
        self._graph, self._capture, self._out = graph, capture, out
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = _pool_bytes(pool)

    def __call__(self):
        with profiling.span("host.program.call"):
            if self._graph is None:
                with self._grad_mode():
                    return self._body()
            self._graph.replay()
            self._capture.replayed()
            return tree_map(torch.clone, self._out)

    def summary(self) -> str:
        """One line: how the program runs, its capture time and pool."""
        if self._graph is None:
            return (f"{self.name}: eager on {self.device} "
                    f"({self.eager_reason})")
        return (f"{self.name}: one CUDA graph per call, captured in "
                f"{self.capture_s:.2f} s (one warm-up call included), "
                f"graph pool {self.pool_bytes / 2 ** 20:.1f} MiB, port "
                f"kernels per replay {self.kernel_launches}")
