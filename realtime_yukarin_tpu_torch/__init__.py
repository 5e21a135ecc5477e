"""realtime_yukarin_tpu_torch — the PyTorch/CUDA port of realtime_yukarin_tpu.

The JAX package beside it stays the reference.  This package carries the
streaming step (analysis -> stage 1 -> super-resolution -> one of three
vocoders) for one stream or N, the serving front ends, offline conversion
and the joint training step, with the same module layout, so each
file's counterpart has the same path under ``realtime_yukarin_tpu/``:

  dsp/        WORLD-role analysis and the harmonic+noise renderer on tensors
  ops/        DFT-as-matmul helpers and the hand-written CUDA kernels' wrappers
  csrc/       CUDA C++ sources of those kernels (built with nvcc at first use)
  models/     stage 1, super-resolution, both neural vocoders and the
              discriminator as nn.Modules
  streaming/  static chunk geometry, the carry, the step (one stream or a
              batch of them) and the host stream
  parallel/   batched N-stream serving (one step, one launch per kernel)
  runtime/    native ring buffers and WAV I/O (C++, built with g++ at first
              use), the pipelined stream, the TCP server, live audio
  training/   losses, the joint and GAN train steps, synthetic batches,
              checkpoints
  utils/      audio I/O, serving metrics, torch.profiler hooks
  cli/        ``python -m realtime_yukarin_tpu_torch.cli.<name>``: convert,
              serve, train

It imports torch and never jax, flax or the JAX package.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors every
kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from realtime_yukarin_tpu_torch.config import Config  # noqa: F401
