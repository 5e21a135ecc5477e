#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and the exit code is
non-zero):

1. device: name, count, ``nvidia-smi`` name and power limit, TF32 flags
   (both set False for the float32 phases);
2. build: every CUDA kernel of ``realtime_yukarin_tpu_torch/csrc`` with
   nvcc (one process per source, started together), with ptxas' report;
3. kernels: each forward kernel against its plain PyTorch version on the
   card at R = 20 rows (one streaming step), R = 100 (one utterance of a
   training batch: what ``make_batch``'s analysis gives the power spectrum
   and the envelope cepstrum), R = 128 (the quality recipe's batch of
   8 x 16 frames: the bank), R = 600 (an offline conversion of 3 s, a
   prepared 3 s file: what its analysis and render give all three),
   R = 800 (the batch: what training's renders give the bank; a prepared
   3.3 s file's analysis), R = 640 (a rank's 32 lanes in phase 18) and
   R = 1280 (64 streams' rows), and the harmonic-bank backward at R = 100,
   128, 800 and 1600 (phase 18's whole batch on each rank of a model
   split) (all four outputs, and
   the training step's launch for d_aL and d_aR only); then, checked but
   not profiled, the rows the other paths give a kernel (``path_rows``:
   the quality recipe's prepared target file and output re-analysis, a
   stream's start at the default, the recipe's and the 20 ms profile's
   Config, the recipe's conditioning-gap render, the 20 ms profile's step
   at one stream and at 64, R = 4 and 256).  For each: the error against the
   plain version and both against a float64 evaluation of the plain
   version (per output for the backward); CUDA-event times of the kernel,
   the plain version and the library yardstick (mean of 200 back-to-back
   calls, so at small R they include the Python wrapper's dispatch);
   device time per call of the kernel, the plain version and the library
   call, measured the same way (``device_ms``: ``torch.profiler`` over 50
   calls, every GPU kernel of the window summed); each wrapper's host time
   per call; the bound reckoned from the shapes (float32 FMA); once, the launch
   floor (the device time of an in-place add on a one-element tensor).  The
   analysis kernels are also checked, unprofiled, at ragged R = 1, 21, 1281
   and at fft_size 1024 (K = 513) for every R above, and both bank kernels
   at ragged (R, H, hop) (BANK_RAGGED_CASES).  The analysis kernels are
   also timed at the serve cells' R = 2,048 and 10,240 (SERVE_CELL_ROWS),
   and both of their designs (the cluster one and the wide one, which the
   wrappers pick by R) side by side at DESIGN_ROWS, each against the plain
   version and float64, with their times, and at ragged R = 2,049 and
   10,239.  Then the HiFi-GAN generator's fused tail
   (``csrc/hifigan_tail.cu``) in bfloat16 at the shapes a streamed step of
   the published generator gives it at HIFIGAN_LANES lanes
   (``hifigan_shapes``: each lane's rows from ``StreamGeometry``, each
   layer's from ``VocoderHiFiGANConfig.cone``): conv_pre's at 512
   channels, then at each of the four upsampling stages the upsample's and
   the mean's (each keeping a window of its rows) and each other mode's:
   bit for bit against its plain version, its device time per launch
   beside the plain version's (``device_ms``), its byte bound, and a
   stage's 19 tails together.  Then the BigVGAN generator's passes at
   the shapes a streamed step of the published BigVGAN v2 generator gives
   them at BIGVGAN_LANES lanes (``bigvgan_shapes``): conv_pre's bias, then
   at each of the six stages each kind of pass (the upsample's, a first
   activation, a residual's, a sum with and without the running sum, the
   mean, activation_post's at the last stage).  Those with an activation
   (``csrc/bigvgan_act.cu``) are held against their plain version in
   float32 (the activation within BIGVGAN_TOL of the peak: the kernel's
   sine is the SFU's) and in bfloat16 (v bit for bit, the activation
   within one bfloat16 rounding); those without (``csrc/hifigan_tail.cu``
   at slope 1) bit for bit.  Each with its device time per launch beside
   the plain version's, its bound (bytes against float32 operations), and
   a stage's 21 passes together;
4. main path: ``VoiceChangerStream(device="cuda")`` at the default Config
   (full width, bf16 models, seeded perturbed weights) on 3 s of a seeded
   voiced/unvoiced signal in 100 ms chunks, then ``flush()``; checks the
   output and that every forward kernel's launch count reached the step
   count;
5. parity: the same input with ``compute_dtype="float32"`` through the
   port on CUDA (the kernels) and on the CPU (the plain versions);
6. training: the default Config at full width in float32, 3 steps of the
   joint train step then 3 of the GAN step (captured programs), each on a
   fresh ``make_batch`` of 8 x 100 frames built on the card (what
   ``cli.train --synthetic`` does per step); checks finite losses, that
   every subtree moved and that the backward kernel ran at least once per
   step;
7. training parity: one step's losses and gradients on CUDA (the kernels,
   cuDNN with TF32 off) and on the CPU (the plain versions), same weights,
   same batch of 2; the wave decoder's leaves are held at the CUDA step's
   own loss cotangent (see PARITY_WAVE_TOL);
8. offline: ``pipeline.offline_convert(device="cuda")`` on the same 3 s
   in the dsp, ddsp and wave modes (bf16, vocoder heads perturbed too):
   output checks, wall time and x realtime, each forward kernel's launches
   (the analysis sends all R = 600 frames to kernels 2 and 3 in one launch
   each, the render all 600 to the bank; phase 3 timed each at R = 600);
   CUDA vs CPU in float32 per mode with identical voicing;
9. streamed == offline on the card: ``VoiceChangerStream`` against
   ``offline_convert`` in float32 in all three modes, on the interior;
10. the ddsp and wave streaming modes and a 48 kHz in / 48 kHz out client
   (bf16): per-chunk p50 / p99, x realtime and each forward kernel's
   launches against the step count;
11. the analysis kernels at the ragged R = 601 (an offline analysis one
   frame longer) against their plain versions;
12. batched serving: ``BatchedServer`` at 64 streams in float32 for 24
   steps on seeded lane signals (gains, f0 scales, silent lanes); lanes
   0, 1, 31, 63 against single ``VoiceChangerStream``s with their lane
   keys (2e-3 of the peak, identical voicing), lane 5 paused for steps
   8-11 (carry bit for bit, zero output), lane 7 reset at step 12 against
   a fresh stream; each forward kernel launched once per step at R = 1280;
   one ``step_device`` under ``torch.cuda.set_sync_debug_mode("error")``;
13. serving throughput (bf16) at 1, 8 and 64 streams: p50 / p99 step wall
   time, aggregate x realtime, launches per step, and a profiler window's
   device busy, idle share and the forward kernels' device time;
14. ``SocketVoiceServer`` (8 slots) with 3 concurrent loopback clients,
   and a 48 kHz in / out server with one, each against a single stream;
15. ``PipelinedStream`` at depth 2 against the synchronous stream (bit for
   bit), then a 600-chunk soak with its dispatch and chunk latency;
16. a 48 kHz client's stream creation (its program's warm-up and capture
   included) and first chunk, from cold caches, three times;
17. the corpus training path: (a) 16 seeded formant pairs of 3.0 s /
   3.3 s prepared on the card at ``bucket_frames=200`` (one launch of
   kernels 2 and 3 per file at R = 600 / 800): wall time, audio seconds
   per second, the DTW's share, launches; one pair prepared again on the
   CPU against it (identical voicing, features within 2e-3 of the peak,
   DTW paths identical or of equal cost within 1e-5); (b) ``cli.train
   --prepared_dir`` at the default Config in float32, batch 8 x 100
   frames, 3 steps, then ``--finetune_converted 3`` and
   ``--export_params``: finite losses, every subtree moved by training,
   only the two vocoders by the fine-tune, kernels 1 and 4 at least once
   per step; (c) ``tools/torch_quality.py``'s recipe (tiny config, 600
   steps, the 300-step fine-tune) on the card: its JSON, each number's
   distance from ``QUALITY.json``, and the JAX package's held-out gates
   (tests/test_full_chain.py); then each kernel's launches per shape over
   (a)-(c), every one of them a shape phase 3 held against the plain
   version;
18. two ranks on this card over ``torch.distributed`` (workers: this
   script run with ``--multihost-worker``, each writing its numbers,
   arrays and kernel launch shapes to a file the parent reads): (a) the
   64 lanes of phase 12 over two gloo ranks (32 each, R = 640 rows per
   launch) through ``step_local``, each rank's rows against phase 12's
   one process (its tolerance, identical voicing; whether bit-equal is
   printed), the same over one NCCL rank (a group of one, with the
   layout's collectives run on it), then bf16 per-rank p50 / p99 step
   time with both ranks stepping, aggregate x realtime, launches per step
   and idle share; (b) 2 joint steps at model_parallel 1 (8 x 100 frames
   per rank) and 2 with the weights split over both ranks (each with the
   whole 16 x 100 batch), against one process on the whole batch: losses
   (phase 7's tolerance), first gradients (PARITY_GRAD_TOL; the wave
   decoder leaf by leaf at the run's own cotangent), kernels 1 and 4 in
   every step; (c) one socket client per rank, bit-equal to one process
   serving it on the same global slot (a server laid out at that rank's
   slots, so its steps have the rank's width); every shape the ranks gave a
   kernel must be one phase 3 held;
19. the captured programs (``streaming/program.py``): (a) replay equals
   eager bit for bit (``torch.equal`` on every output and every carry
   leaf): 32 steps of ``VoiceChangerStream`` in dsp, ddsp and wave, a
   48 kHz in / out client (bf16) and dsp in float32, each against the
   ``streaming_step`` loop from the same init carry; ``BatchedServer`` at
   64 lanes over phase 12's schedule against ``make_batched_step``'s step
   (and an output held across the next step unchanged); ``offline_convert``
   of 3 s in each mode, called three times (the first runs eagerly, the
   second captures, the third replays), against ``offline_convert_eager``;
   (b) per program: warm-up plus capture time, pool bytes, each forward
   kernel's launches per replay (exactly 1 as captured, as listed by
   ``torch.profiler`` on the device, and as counted over 3 replays);
   (c) eager and captured side by side in bf16: the stream step's p50 /
   p99 per mode with the GPU kernels per replay and per eager step
   (``torch.profiler``), the batched step at N = 1, 8, 64 (p50 / p99,
   aggregate x realtime, device busy and idle share by the profiler, host
   launch and copy calls per step), offline 3 s (eager, the first call,
   the second with its capture, a replay);
20. the captured training steps (``training/train_step.py:StepProgram``)
   at the default Config in float32 on 8 x 100-frame batches: (a) two
   eager runs of 4 steps from one state bit-equal (every parameter,
   moment, step count, EMA and discriminator leaf, every metric) for the
   joint, GAN and fine-tune steps; (b) 8 replays of each against its eager
   body bit for bit, the analysis program at 100 frames and at a prepared
   3.3 s file's bucket (800 frames) against ``offline_analyze_eager``, the
   synthesis program against ``offline_synthesize_eager``; (c) each
   program's port kernels per replay equal to the eager step's, as
   captured, as counted over 3 replays and as ``torch.profiler`` lists
   them; (d) eager and captured side by side: each step's p50 / p99,
   device busy and idle share, host launch calls, capture time and pool;
   ``make_batch`` as its host synthesis and its analysis eager and
   captured; phase 17 (a)'s preparation with eager analysis and through
   the programs; the quality recipe's wall time (phase 17 (c));
21. the step's cost (``BatchedServer.step_cost_analysis``,
   ``model_stage_flops``; ``utils/cost.py``): (a) the default profile
   (dsp, bf16) counted at N = 1, 8, 64 on the card and on the CPU at the
   same Config and weights, FLOPs and the learned stages' FLOPs equal
   exactly, bytes printed with the ops where they part; (b) the counted
   kernel launches and their R equal to one replay's launch record; (c)
   after a count, the next replay bit-equal to a second server's that
   never counted; (d) FLOPs, bytes, learned and structural FLOPs, the
   kernels' share, the captured step's p50 and the achieved TFLOP/s as a
   share of the bf16 and float32 peaks (not an MFU), a count refused
   inside a capture; ddsp and wave counted at N = 8; (e) bench.py's 20 ms
   profile (20 ms chunks, causal contour search, stage 1 3 x k3, SR 1
   block): one captured stream against its eager loop bit for bit and
   CUDA vs CPU in float32 (2e-3 of the peak, identical voicing), a
   captured server at 64 lanes against its eager step and timed, every
   kernel shape one phase 3 held (R = 4 and 256 are in ``path_rows``),
   then its step counted;
22. the hifigan mode: a captured ``BatchedServer`` at HIFIGAN_LANES lanes
   of the published generator (bf16) for HIFIGAN_STEPS replays after its
   capture: the tail launched once per gap between two convolutions a
   replay (77), as captured and as counted, every shape it was given one
   phase 3 held, the output finite and not silent, the step's p50 / p99;
    then the bigvgan mode: a captured ``BatchedServer`` at BIGVGAN_LANES
   lanes of the published BigVGAN v2 generator (bf16) for BIGVGAN_STEPS
   replays: a pass launched once per gap between two convolutions a
   replay (109 of ``bigvgan_act``, 18 of ``hifigan_tail``), as captured
   and as counted, every shape each was given one
   phase 3 held, the output finite and not silent, the step's p50 / p99;
23. the kernels line: one JSON object with every kernel's numbers;
24. last line: ``{"ok": true, "device": {...}}``.

Phases 4, 6, 8-10, 12-17 (and 18's serving and its one-process training
reference) run the captured programs: their launch counts come from the
replay accounting of ``ops/cuda.py``.

Exits non-zero without a result when CUDA is not available or the port's
package is missing.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SEED = 0
SECONDS = 3.0
PERTURB = 1e-3   # scale of the seeded noise added to every weight
# error / peak of the plain version's output; the harmonic bank's (both
# directions) is the Chebyshev recurrence against sin/cos(h * phi) at
# h * phi ~ 5000 rad, where float32 phase rounding is ~5e-4 rad
TOL = {"harmonic_bank": 1e-3, "power_spectrum": 1e-4,
       "envelope_cepstrum": 1e-4, "harmonic_bank_bwd": 1e-3}
REPLACES = {
    "harmonic_bank": "realtime_yukarin_tpu/ops/pallas_synth.py:33",
    "power_spectrum": "realtime_yukarin_tpu/ops/pallas_analysis.py:100",
    "envelope_cepstrum": "realtime_yukarin_tpu/ops/pallas_analysis.py:169",
    "harmonic_bank_bwd": "realtime_yukarin_tpu/ops/pallas_synth.py:101",
    "hifigan_tail": "none: added for the hifigan mode, which the JAX "
                    "package lacks",
    "bigvgan_act": "none: added for the bigvgan mode, which the JAX "
                   "package lacks",
}
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS = 8, 100, 3
# rows of one training or fine-tune batch of the quality recipe (8 x 16
# frames: training/full_chain.py's train_plain and
# finetune_vocoder_on_converted)
QUALITY_ROWS = 8 * 16
# frames of one offline conversion of SECONDS at the default 24 kHz, hop 120
OFFLINE_FRAMES = int(SECONDS * 24000) // 120
# Forward kernels' row counts in phase 3 (timed): a streaming step (all
# three); one utterance of a training batch (the analysis); the quality
# recipe's batch (the bank) and its prepared 0.6 s source file (the
# analysis: 120 frames at bucket 32); an offline conversion and a prepared
# 3 s file (all three); the batch (the bank) and a prepared 3.3 s file (the
# analysis); a rank's 32 of 64 streams (phase 18); 64 streams.  path_rows
# adds the rest, untimed.
KERNEL_ROWS = (20, TRAIN_FRAMES, QUALITY_ROWS, OFFLINE_FRAMES,
               TRAIN_BATCH * TRAIN_FRAMES, 640, 1280)
# The analysis kernels also at ragged row counts (one row, one past a row
# group, one past 64 streams) and at fft_size 1024 (K = 513, the COMPAT
# configuration), checked but not profiled
ANALYSIS_KERNELS = ("power_spectrum", "envelope_cepstrum")
RAGGED_CASES = tuple((1022, R) for R in (1, 21, 1281)) + tuple(
    (1024, R) for R in (1, 20, 21, 100, 800, 1280, 1281))
# The serve cells' rows (512 lanes of the 20 ms and of the default profile,
# benchmark/configs): the analysis kernels timed there too, with bound,
# plain version and library call
SERVE_CELL_ROWS = (4 * 512, 20 * 512)
# Both designs of kernels 2-3 (ops/analysis.py: the cluster design below
# POWER_WIDE_ROWS / CEPSTRUM_WIDE_ROWS rows, the wide one from there) timed
# and held to float64 at the crossover table's rows, and held at ragged rows
# past the serve cells'
DESIGN_ROWS = (128, 256, 320, 600, 800, 1024, 1280, 2048, 10240)
DESIGN_RAGGED_ROWS = (2049, 10239)
# The hifigan mode's lanes (those of the hifigan.serve256 cell) in phases
# 3 and 22, and phase 22's replays.  Phase 3 runs the generator's fused
# tail in bfloat16, each mode as an upsampling stage runs it: (mode, with
# the stage's running sum, tails of that kind in a stage at the published
# widths)
HIFIGAN_LANES, HIFIGAN_STEPS = 256, 8
TAIL_CASES = (("up", False, 1), ("act", False, 9), ("res", False, 6),
              ("sum", False, 1), ("sum", True, 1), ("mean", True, 1))
# The bigvgan mode's lanes (those of the bigvgan.serve128 cell) in phases
# 3 and 22, and phase 22's replays.  Phase 3 runs the generator's passes in
# each kind a stage runs them: (kind, operands, activation, v kept, passes
# of that kind in a stage at the published widths: the upsample's, the
# first activations (a block's own and each first conv's), the residuals',
# the first block's sum, the second's and the mean, which activates in the
# last stage alone).  A pass with no activation is hifigan_tail's in the
# mode BIGVGAN_TAIL_MODES names.
BIGVGAN_LANES, BIGVGAN_STEPS = 128, 6
BIGVGAN_CASES = (("up", 1, True, True, 1), ("act", 1, True, False, 11),
                 ("res", 2, True, True, 6), ("sum", 2, False, False, 1),
                 ("sum+", 3, False, False, 1), ("mean", 3, None, False, 1))
BIGVGAN_TAIL_MODES = {"bias": "act", "sum": "sum", "sum+": "sum",
                      "mean": "mean"}
# the activation's error / peak of the plain version's output in float32:
# the kernel's __sinf against torch.sin (about 1e-6 of the argument) and
# another order of the filters' sums; in bfloat16 one rounding of each
# value (2**-7 of it) on top, where a float32 difference of that size near
# a rounding boundary moves the rounding
BIGVGAN_TOL = 1e-5
# Both bank kernels at ragged (R, H, hop): one row, one past a row block,
# one past the batch; one harmonic, one past a 32-group, the COMPAT 128,
# the default 161; the default hop and one above 128 that is no multiple of
# 32 (two sample chunks), checked but not profiled
BANK_RAGGED_CASES = tuple((R, H, hop) for R in (1, 21, 801)
                          for H in (1, 33, 128, 161) for hop in (120, 200))
# CUDA vs CPU, one training step (float32 on both; cuBLAS/cuFFT/the kernels
# vs MKL/pocketfft/the plain versions sum in other orders): the losses
# relative; stage 1, stage 2 and the DDSP vocoder's gradients as a fraction
# of each subtree's peak.
PARITY_LOSS_TOL = 1e-4
PARITY_GRAD_TOL = {"stage1": 1e-4, "stage2": 1e-4, "vocoder": 2e-3}
# The wave decoder's step gradient is J^T c: J its render's Jacobian, c the
# cotangent d(0.5 * wave STFT loss) / d render.  c weighs an STFT bin by
# 1 / (|X| + 1e-6), and the render's DC and Nyquist bins sit near float32
# rounding, so c is not determined by float32 arithmetic on either device
# (tools/torch_wave_grad_conditioning.py: every leaf, the cotangent too, is
# as far from a float64 witness as the whole subtree).  Each leaf is held
# at the CUDA step's own c instead: the CUDA step gradient against the CPU
# render's J^T c, as a fraction of the leaf's peak.  frac_ratios is the
# least well determined leaf of J^T c (its terms carry the unwrapped phase
# advance, up to 578 rad): at the float64 cotangent its float32 value lies
# 3.8e-4 (CPU) and 5.5e-4 (CUDA) of its peak from float64's, every other
# leaf's within 2.5e-4; at the CUDA step's cotangent CUDA and CPU differ by
# 1.7e-3 (the same tool and this script on an H100 80GB HBM3; PERF.md).
PARITY_WAVE_TOL = {"frac_ratios": 1e-2}
PARITY_WAVE_LEAF_TOL = 1e-3
VOCODER_MODES = ("dsp", "ddsp", "wave")
# scale of the seeded noise on the neural vocoders' leaves in phases 8-10
# (tests/test_streaming.py's, which makes the wave residual active)
VOCODER_PERTURB = 1e-2
# streamed == offline on the interior, of the offline output's peak: the
# JAX package's tolerances (tests/test_streaming.py; wave 3e-3)
STREAM_OFFLINE_TOL = {"dsp": 2e-3, "ddsp": 2e-3, "wave": 3e-3}
CLIENT_RATE = 48000
FORWARD_KERNELS = ("harmonic_bank", "power_spectrum", "envelope_cepstrum")
# the four TPU kernels' counterparts, every one of which the training paths
# launch (the generator's tail runs in the hifigan mode alone)
TPU_KERNELS = FORWARD_KERNELS + ("harmonic_bank_bwd",)
# Phase 12: BatchedServer at 64 streams (R = 1280 rows per kernel launch)
# for 24 steps in float32; these lanes held to single streams, one lane
# paused for four steps, one reset; batched vs single stream within the
# streamed == offline tolerance (cuBLAS / cuDNN pick other algorithms at
# [N*F, ...] than at [F, ...], so it is a float32 tolerance, not equality)
BATCH_STREAMS, BATCH_STEPS = 64, 24
BATCH_HELD = (0, 1, 31, 63)
PAUSED_LANE, PAUSE_STEPS = 5, (8, 11)
RESET_LANE, RESET_STEP = 7, 12
BATCH_TOL = 2e-3
# Phase 13: serving throughput in bf16 at these stream counts
SERVE_STREAMS = (1, 8, 64)
SERVE_WARMUP, SERVE_STEPS, PROFILE_STEPS = 4, 32, 5
LANE_STEPS = max(BATCH_STEPS, SERVE_WARMUP + SERVE_STEPS + PROFILE_STEPS)
# Phase 14: the socket server's slots, clients and seconds per client
SOCKET_STREAMS, SOCKET_CLIENTS, SOCKET_SECONDS = 8, 3, 2.0
# Phase 15: the pipelined soak (one simulated minute)
SOAK_CHUNKS = 600
# Phase 16: a 48 kHz client's creation and first chunk, this many times
FIRST_CHUNK_RUNS = 3
# Phase 18: two ranks on this card over gloo (their workers are this script
# run with MH_FLAG).  Serving: BATCH_STREAMS lanes, half on each rank
# (R = 20 * 32 = 640 rows per kernel launch), phase 12's schedule and
# tolerance.  Training: TRAIN_BATCH x TRAIN_FRAMES rows per rank, each
# half of the one-process batch, MH_TRAIN_STEPS steps at model_parallel 1,
# then as many with the weights split over both ranks, each holding the
# whole batch.  The socket: MH_SOCKET_STREAMS slots, one client per rank.
MH_FLAG = "--multihost-worker"
MH_RANKS, MH_TRAIN_STEPS = 2, 2
MH_ROWS = 20 * BATCH_STREAMS // MH_RANKS
MH_TRAIN_ROWS = MH_RANKS * TRAIN_BATCH * TRAIN_FRAMES
MH_SOCKET_STREAMS, MH_SOCKET_SECONDS = 8, 1.0
MH_SOCKET_ROWS = 20 * MH_SOCKET_STREAMS // MH_RANKS
MH_TIMEOUT_S = 300          # one worker run, start-up included
MH_GROUP_TIMEOUT_S = 120    # a collective that waits longer raises
# Phase 19: the captured programs.  Streams (vocoder mode, compute dtype,
# client rate in and out or None for 24 kHz) held bit for bit to the eager
# step over CAPTURE_STEPS steps; the first four are also timed in bf16.
# Each program replayed CAPTURE_COUNT more times to count its launches.
CAPTURE_STEPS, CAPTURE_COUNT = 32, 3
CAPTURE_STREAMS = (("dsp", "bfloat16", None), ("ddsp", "bfloat16", None),
                   ("wave", "bfloat16", None),
                   ("dsp", "bfloat16", CLIENT_RATE),
                   ("dsp", "float32", None))
# Phase 20: the captured training steps at the default Config in float32 on
# TRAIN_BATCH x TRAIN_FRAMES batches: two eager runs of DET_STEPS steps from
# one state, then TRAIN_REPLAYS replays against the eager body, per
# objective; the fine-tune at its optimizer's learning rate.
TRAIN_OBJECTIVES = ("joint", "gan", "finetune")
DET_STEPS, TRAIN_REPLAYS, FINETUNE_LR = 4, 8, 3e-4
TRAIN_TIMED = 16            # steps timed per objective and way
# Phase 21: the step's cost (BatchedServer.step_cost_analysis) at the
# default profile (dsp, bf16) at COST_STREAMS lanes, counted on the card and
# on the CPU at the same Config and weights; ddsp and wave at
# COST_MODE_STREAMS lanes; bench.py's 20 ms profile (low_latency_config) on
# the card: one stream and a server at LL_STREAMS lanes, captured.
COST_STREAMS = (1, 8, 64)
COST_MODE_STREAMS = 8
LL_STREAMS = 64
# H100 SXM published dense bf16 peak (NVIDIA data sheet), beside
# PEAK_F32_FLOPS as a share of achieved FLOP/s
PEAK_BF16_FLOPS = 989e12


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Device time of ``fn`` in ms per call: ``torch.profiler`` over
    ``iters`` back-to-back calls, every GPU kernel and copy of the window
    summed (one stream, so they do not overlap), divided by ``iters``.
    Kernel and library call are measured the same way.  Every call
    launches the same GPU work, so a window whose count of GPU events is
    not a positive multiple of ``iters`` lost some (the profiler drops
    events now and then, which reads too low): it is traced again, up to
    five times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if times and len(times) % iters == 0:
            return sum(times) / iters / 1e3
    raise AssertionError(f"torch.profiler traced {len(times)} GPU events "
                         f"over {iters} calls, five times")


def host_us(fn, iters: int = 200) -> float:
    """Host time of one call in us: the enqueue, no device sync inside."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and float32 operations
    over the FMA peak, and which of the two it is."""
    t_mem = n_bytes / PEAK_HBM_BYTES
    t_ops = n_flops / PEAK_F32_FLOPS
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def torch_quality():
    """The quality tool's module (tools/torch_quality.py)."""
    import pathlib
    tools = str(pathlib.Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import torch_quality as tq
    return tq


def path_rows(cfg) -> tuple[list[int], list[int]]:
    """Row counts the paths give the kernels besides KERNEL_ROWS, from
    their own constants: (analysis rows, bank rows).

    The analysis: the quality recipe's prepared target file (0.66 s at
    bucket 32: 132 frames -> 160 rows), its full-chain output re-analysed
    at the held-out source's length (0.6 s: 120), and a stream's start
    (the analysis of its cache frames of silence) in each vocoder mode at
    the default, the recipe's and the 20 ms profile's Config; a rank's
    lanes in phase 18 (MH_ROWS) and its socket slots (MH_SOCKET_ROWS);
    the 20 ms profile's step at one stream and at LL_STREAMS (phase 21:
    4 and 256 rows).  The bank: the recipe's conditioning gap, which
    renders a whole target file (132 rows); the same two phase 18 widths
    and the batch a model split gives each rank there (MH_TRAIN_ROWS); the
    20 ms profile's two step widths."""
    from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry
    from realtime_yukarin_tpu_torch.training.corpus import frame_bucket
    from realtime_yukarin_tpu_torch.training.data import (FORMANT_BUCKET,
                                                          FORMANT_SECONDS)

    qcfg = torch_quality().quality_config()
    src_f, tgt_f = (int(s * qcfg.dsp.sample_rate) // qcfg.dsp.hop
                    for s in FORMANT_SECONDS)
    analysis = {frame_bucket(F, FORMANT_BUCKET) for F in (src_f, tgt_f)}
    analysis.add(src_f)
    ll = low_latency_config(cfg)
    analysis |= {StreamGeometry.from_config(c, True, vocoder_mode=m)
                 .cache_frames for c in (cfg, qcfg, ll)
                 for m in VOCODER_MODES}
    analysis |= {MH_ROWS, MH_SOCKET_ROWS}
    bank = {tgt_f, MH_ROWS, MH_SOCKET_ROWS, MH_TRAIN_ROWS}
    # the 20 ms profile's step: one stream and LL_STREAMS lanes (phase 21)
    ll_fc = StreamGeometry.from_config(ll).chunk_frames
    analysis |= {ll_fc, ll_fc * LL_STREAMS}
    bank |= {ll_fc, ll_fc * LL_STREAMS}
    return ([R for R in sorted(analysis) if R not in KERNEL_ROWS],
            [R for R in sorted(bank) if R not in KERNEL_ROWS])


def launch_shape(name: str, args: tuple) -> tuple:
    """The shape a kernel's launcher arguments give it (ops/analysis.py,
    ops/harmonic_bank.py, ops/hifigan_tail.py): (R, K) for the analysis
    kernels, (R, H, hop) for the bank, (R, H, hop, whether d_phi and d_frac
    are computed) for its backward, (rows, T, C, mode, y's samples a row,
    the first one kept) for the generator's tail, (rows, T, C, operands,
    v kept, the operand's rows, y's samples a row, the first one kept) for
    the BigVGAN generator's activation pass."""
    if name == "power_spectrum":
        return int(args[3]), int(args[5])
    if name == "envelope_cepstrum":
        return int(args[4]), int(args[5])
    if name == "harmonic_bank":
        return tuple(int(a) for a in args[5:8])
    if name == "hifigan_tail":
        rows, length, C = (int(a) for a in args[6:9])
        return (rows, length, C, int(args[11]), int(args[9]) // C,
                int(args[10]))
    if name == "bigvgan_act":
        rows, extent, y_row, start, length, C = (int(a) for a in args[9:15])
        return (rows, length, C, 1 + (args[1] is not None)
                + (args[2] is not None), args[7] is not None, extent,
                y_row // C, start)
    return tuple(int(a) for a in args[9:12]) + (args[7] is not None,)


def kernel_phase(kname: str, R: int, n: int, case: Case,
                 timed: bool = True) -> dict:
    """Check one kernel call against its plain version (and both against
    float64, where there is a float64 chain); time it unless ``timed`` is
    False.  Prints one line; returns the kernels-line record."""
    import torch
    out, ref = case.kernel(), case.plain()
    err_abs, err = abs_rel_err(out, ref)
    torch.cuda.synchronize()
    ok = err <= TOL[kname]
    line = (f"[kernel] {kname} R={R}"
            + (f" n={n}" if kname in ANALYSIS_KERNELS else "")
            + f": max_err {err_abs:.3e}, /peak={err:.3e} (tol "
            f"{TOL[kname]:g}) {'ok' if ok else 'FAIL'}")
    if case.ref64 is not None:
        ref64 = case.ref64()
        _, e_k = abs_rel_err(out.double(), ref64)
        _, e_p = abs_rel_err(ref.double(), ref64)
        line += f" | vs float64 /peak: kernel {e_k:.3e}, plain {e_p:.3e}"
    if not ok:
        print(line)
        raise AssertionError(f"{kname} R={R} n={n}: error {err:.3e} above "
                             f"{TOL[kname]:g}")
    if not timed:
        print(line + f" | kernel {time_ms(case.kernel, 50, 5):.5f} ms")
        return {}
    ms, plain_ms = time_ms(case.kernel), time_ms(case.plain)
    lib_ms = time_ms(case.library) if case.library is not None else None
    dev_ms, plain_dev = device_ms(case.kernel), device_ms(case.plain)
    lib_dev = device_ms(case.library) if case.library is not None else None
    b_ms, b_by = bound_ms(case.nbytes, case.flops)
    bounds = f"bound {b_ms:.5f} ms ({b_by}, float32 FMA)"
    lib_txt = (f"{lib_ms:.5f} ms (device {lib_dev:.5f} ms)"
               if lib_ms is not None else "n/a")
    host = f", wrapper host {host_us(case.kernel):.1f} us/call"
    print(line + f" | kernel {ms:.5f} ms (device {dev_ms:.5f} ms{host}), "
          f"plain {plain_ms:.5f} ms (device {plain_dev:.5f} ms), library "
          f"{lib_txt}, {bounds}")
    return dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                plain_device_ms=plain_dev, library_device_ms=lib_dev)


def designs_phase(cfg, dev, rng) -> None:
    """Both designs of the power spectrum and the envelope cepstrum on the
    same inputs at DESIGN_ROWS (timed: CUDA events, 50 calls) and
    DESIGN_RAGGED_ROWS: each one's error against the plain version and
    against float64, which design the wrappers pick, and the wide design's
    float64 error beside the cluster design's."""
    import torch
    from realtime_yukarin_tpu_torch.ops import analysis as an
    n = cfg.dsp.fft_size
    K = n // 2 + 1
    db = cfg.dsp.envelope_floor_db
    designs = {
        "power_spectrum": (lambda R: an.cluster_power_plan(R, n),
                           lambda R: an.WIDE_POWER_PLAN),
        "envelope_cepstrum": (lambda R: an.cluster_cepstrum_plan(R, K),
                              lambda R: an.wide_cepstrum_plan(K))}
    for R in DESIGN_ROWS + DESIGN_RAGGED_ROWS:
        timed = R in DESIGN_ROWS
        cases = kernel_cases(R, cfg, dev, rng)
        (frames,) = cases["power_spectrum"].inputs
        P, lift = cases["envelope_cepstrum"].inputs
        for kname, plans in designs.items():
            case = cases[kname]
            plain, ref64 = case.plain(), case.ref64()
            picked = (an.power_plan(R, n) if kname == "power_spectrum"
                      else an.cepstrum_plan(R, K))
            line, e64 = f"[designs] {kname} R={R}:", {}
            for label, plan_of in zip(("cluster", "wide"), plans):
                plan = plan_of(R)

                def call(plan=plan):
                    if kname == "power_spectrum":
                        return an.power_spectrum_launch(frames, n, plan)
                    return an.envelope_cepstrum_launch(P, lift, n, db, plan)
                out = call()
                _, err = abs_rel_err(out, plain)
                _, e64[label] = abs_rel_err(out.double(), ref64)
                torch.cuda.synchronize()
                ok = err <= TOL[kname]
                line += (f" {label}{' (picked)' if plan == picked else ''}"
                         f" /peak {err:.3e}, vs float64 {e64[label]:.3e}"
                         + (f", {time_ms(call, 50, 5) * 1e3:.2f} us"
                            if timed else "") + " |")
                if not ok:
                    print(line)
                    raise AssertionError(f"{kname} {label} design at R={R}: "
                                         f"error {err:.3e} above "
                                         f"{TOL[kname]:g}")
            _, p64 = abs_rel_err(plain.double(), ref64)
            print(line + f" plain vs float64 {p64:.3e}; wide vs float64 no "
                  f"worse than cluster: {e64['wide'] <= e64['cluster']}")


def hifigan_shapes(cfg) -> list[tuple]:
    """(rows, samples a row kept, channels, y's samples a row, the first
    one kept) of each tail that keeps a window of its rows in a streamed
    step of ``cfg``'s generator at HIFIGAN_LANES lanes: conv_pre's, then
    per upsampling stage its upsample's and its mean's.  A lane's window is
    the chunk's frames, one more, and the generator's halo on each side
    (``streaming/pipeline.py``'s Lv); each layer runs over the rows the
    kept samples depend on (``VocoderHiFiGANConfig.cone``): the upsample
    keeps the stage's rows of its transposed conv's output, the stage's
    other tails run over those rows whole, and its mean keeps the rows the
    next conv reads."""
    from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry
    h = cfg.vocoder_hifigan
    geo = StreamGeometry.from_config(cfg, vocoder_mode="hifigan")
    T = geo.chunk_frames + 1 + 2 * h.context_frames
    x, *cone = h.cone(T, h.context_frames)
    shapes = [(HIFIGAN_LANES, cone[0][1] - cone[0][0],
               h.upsample_initial_channel, x[1] - x[0], cone[0][0] - x[0])]
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes)):
        (lo, hi), rows, out = cone[2 * i: 2 * i + 3]
        up = (hi - lo - 1) * u - 2 * ((k - u) // 2) + k
        n = rows[1] - rows[0]
        shapes += [(HIFIGAN_LANES, n, h.channels(i), up, rows[0] - lo * u),
                   (HIFIGAN_LANES, out[1] - out[0], h.channels(i), n,
                    out[0] - rows[0])]
    return shapes


def hifigan_tails(cfg) -> int:
    """The tail's launches in one step of ``cfg``'s generator: conv_pre's,
    then per stage the upsample's and one after each resblock conv."""
    h = cfg.vocoder_hifigan
    return 1 + len(h.upsample_rates) * (
        1 + 2 * sum(len(ds) for ds in h.resblock_dilation_sizes))


def tail_phase(cfg, dev) -> tuple[dict, set]:
    """The generator's fused tail (``cfg``'s generator) in bfloat16 at
    ``hifigan_shapes``: conv_pre's act, then each of TAIL_CASES at each
    upsampling stage, the upsample's and the mean's keeping their windows:
    equal to the plain version bit for bit, device
    time per launch (``device_ms``) beside the plain version's, the byte
    bound (``hifigan_tail_cost`` over HBM bandwidth).  Prints a line per
    case and one per stage (its tails together); returns the kernels-line
    record and the shapes held (``launch_shape``'s)."""
    import torch
    from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht
    g = torch.Generator().manual_seed(SEED)
    stages, shapes = [], set()

    def t(*shape):
        return torch.randn(shape, generator=g).bfloat16().to(dev)

    def case(label, mode, with_acc, rows, T, C, Ty, start, bias, r, acc):
        """One mode at one shape: its (kernel, plain, bound) ms."""
        y = t(rows, Ty, C)
        rr = r if mode in ("res", "sum", "mean") else None
        # "sum" adds into the running sum in place: a copy each call
        fresh = mode == "sum" and with_acc

        def run(fn):
            a = acc.clone() if fresh else (acc if with_acc else None)
            return fn(mode, y, bias, rr, a, 0.1, 3.0, T, start)
        same = all(torch.equal(a, b) for a, b in zip(
            run(ht.hifigan_tail), run(ht.hifigan_tail_plain)))
        torch.cuda.synchronize()
        _, nbytes = ht.hifigan_tail_cost(mode, rows, T, C, 2, with_acc)
        b_ms = nbytes / PEAK_HBM_BYTES * 1e3
        copy = device_ms(lambda: acc.clone()) if fresh else 0.0
        k_ms = device_ms(lambda: run(ht.hifigan_tail)) - copy
        p_ms = device_ms(lambda: run(ht.hifigan_tail_plain), 10) - copy
        print(f"[kernel] hifigan_tail {label} {mode}"
              f"{' +sum' if with_acc else ''} ({rows}, {T}, {C}) from "
              f"{Ty} a row at {start}, bf16: equal to plain {same} | device "
              f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us (bytes; {100 * b_ms / k_ms:.1f}% of "
              f"it)")
        if not same:
            raise AssertionError(f"hifigan_tail {mode} at {(rows, T, C)} "
                                 f"from {Ty} a row at {start}: kernel and "
                                 f"plain version differ")
        shapes.add((rows, T, C, ht.MODES.index(mode), Ty, start))
        return k_ms, p_ms, b_ms

    (rows, T, C, Ty, start), *after = hifigan_shapes(cfg)
    pre = case("conv_pre", "act", False, rows, T, C, Ty, start,
               torch.randn(C, generator=g).to(dev), None, None)
    for i, (up, mean) in enumerate(zip(after[::2], after[1::2])):
        rows, T, C = up[:3]
        bias = torch.randn(C, generator=g).to(dev)
        r, acc = t(rows, T, C), t(rows, T, C)
        stage = dict(kernel=0.0, plain=0.0, bound=0.0)
        for mode, with_acc, count in TAIL_CASES:
            window = {"up": up, "mean": mean}.get(mode, (rows, T, C, T, 0))
            ms = case(f"s{i + 1}", mode, with_acc, rows, window[1], C,
                      *window[3:], bias, r, acc)
            for key, m in zip(("kernel", "plain", "bound"), ms):
                stage[key] += count * m
        print(f"[kernel] hifigan_tail s{i + 1}: a stage's "
              f"{sum(c for *_, c in TAIL_CASES)} tails "
              f"{stage['kernel']:.4f} ms (plain {stage['plain']:.4f} ms), "
              f"bound {stage['bound']:.4f} ms "
              f"({100 * stage['bound'] / stage['kernel']:.1f}%)")
        stages.append(stage)
    total = {k: sum(st[k] for st in stages) + m
             for k, m in zip(("kernel", "plain", "bound"), pre)}
    print(f"[kernel] hifigan_tail: conv_pre's and the stages' tails "
          f"{total['kernel']:.4f} ms a step at {HIFIGAN_LANES} lanes (plain "
          f"{total['plain']:.4f} ms), bound {total['bound']:.4f} ms")
    record = dict(max_abs_err=0.0, ms=None, plain_ms=None,
                  bound_ms=total["bound"], bound_by="bytes", library_ms=None,
                  device_ms=total["kernel"], plain_device_ms=total["plain"],
                  library_device_ms=None,
                  stage_device_ms=[st["kernel"] for st in stages])
    return record, shapes


def bigvgan_shapes(cfg) -> list[tuple]:
    """(rows, samples a row kept, channels, the operand's rows, y's samples
    a row, the first one kept) of conv_pre's bias pass, then per stage of
    its upsample's pass (which keeps the stage's rows of the transposed
    conv's output, a crop for an odd rate) and of its mean (which keeps the
    rows the next layer reads), in a streamed step of ``cfg``'s BigVGAN
    generator at BIGVGAN_LANES lanes: each layer over the rows the kept
    samples depend on (``VocoderBigVGANConfig.cone``, on the window's
    pairs of frames)."""
    from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry
    b = cfg.vocoder_bigvgan
    geo = StreamGeometry.from_config(cfg, vocoder_mode="bigvgan")
    halo = b.halo_frames(cfg.dsp.hop)
    T = geo.chunk_frames + 1 + 2 * halo
    x, *cone = b.cone(T, halo, cfg.dsp.hop)
    n = x[1] - x[0]
    shapes = [(BIGVGAN_LANES, cone[0][1] - cone[0][0],
               b.upsample_initial_channel, n, n, cone[0][0] - x[0])]
    last = len(b.upsample_rates) - 1
    for i, (u, k) in enumerate(zip(b.upsample_rates,
                                   b.upsample_kernel_sizes)):
        (lo, hi), rows = cone[2 * i: 2 * i + 2]
        out = cone[-2] if i == last else cone[2 * i + 2]
        up = (hi - lo - 1) * u - 2 * ((k - u) // 2) + k
        R = rows[1] - rows[0]
        shapes += [(BIGVGAN_LANES, R, b.channels(i), up - up % u, up,
                    rows[0] - lo * u),
                   (BIGVGAN_LANES, out[1] - out[0], b.channels(i), R, R,
                    out[0] - rows[0])]
    return shapes


def bigvgan_passes(cfg) -> tuple[int, int]:
    """(passes, those with an activation) in one forward of ``cfg``'s
    BigVGAN generator: conv_pre's bias, then per stage the upsample's, a
    first activation for each block after the first, two per dilation of
    each block (the last of each block a sum or the mean), and
    activation_post in the last stage's mean.  Those with an activation
    are ``bigvgan_act``'s launches, the rest ``hifigan_tail``'s."""
    b = cfg.vocoder_bigvgan
    blocks = len(b.resblock_kernel_sizes)
    per_stage = blocks + 2 * sum(len(ds) for ds in b.resblock_dilation_sizes)
    stages = len(b.upsample_rates)
    return 1 + stages * per_stage, stages * (per_stage - blocks) + 1


def bigvgan_act_phase(cfg, dev) -> tuple[dict, set, set]:
    """The BigVGAN generator's passes at ``bigvgan_shapes``: conv_pre's
    bias, then each of BIGVGAN_CASES at each stage, the upsample's and the
    mean's keeping their windows.  With an activation (``bigvgan_act``): in
    float32 the activation within BIGVGAN_TOL of the plain version's peak
    and v bit for bit; in bfloat16 v bit for bit and the activation within
    one rounding of the plain version's and BIGVGAN_TOL of its peak.
    Without (``hifigan_tail`` at slope 1): bit for bit in both.  Each with
    its device time per launch (``device_ms``) beside the plain version's,
    and its bound (``bigvgan_act_cost`` or ``hifigan_tail_cost``: bytes
    over HBM bandwidth against FLOPs over the float32 peak).  Prints a line
    per case and one per stage; returns the kernels-line record and the
    shapes held (``launch_shape``'s) of each kernel."""
    import torch
    from realtime_yukarin_tpu_torch.ops import bigvgan_act as ba
    from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht
    g = torch.Generator().manual_seed(SEED)
    act_shapes, tail_shapes, stages = set(), set(), []
    worst = 0.0

    def case(label, kind, operands, act, keep_v, rows, T, C, extent, Ty,
             start, last):
        """One kind at one shape: its (kernel, plain, bound) ms."""
        nonlocal worst
        act = last if act is None else act
        mode = None if act else BIGVGAN_TAIL_MODES[kind]
        # a running sum kept whole is added into in place: a copy each call
        fresh = mode == "sum" and operands == 3
        for dtype in (torch.float32, torch.bfloat16):
            y, r, acc = (torch.randn((rows, Ty, C), generator=g).to(dtype)
                         .to(dev) if k < operands else None
                         for k in range(3))
            bias = torch.randn(C, generator=g).to(dev)
            snake = (torch.exp(0.5 * torch.randn(C, generator=g)).to(dev),
                     torch.exp(0.5 * torch.randn(C, generator=g)).to(dev))
            divisor = 3.0 if kind == "mean" else 1.0

            def run(fn, y=y, r=r, acc=acc, bias=bias, snake=snake,
                    divisor=divisor):
                a = acc.clone() if fresh else acc
                if act:
                    return fn(y, snake, bias, r, a, divisor, keep_v, start,
                              T, extent)
                return fn(mode, y, bias, r, a, 1.0, divisor, T, start)
            if act:
                got, want = run(ba.bigvgan_act), run(ba.bigvgan_act_plain)
            else:
                got, want = run(ht.hifigan_tail), run(ht.hifigan_tail_plain)
            torch.cuda.synchronize()
            same_v = not (keep_v or not act) or torch.equal(got[0], want[0])
            ok_a = True
            if act:
                k, p = got[-1].float(), want[-1].float()
                if dtype == torch.float32:
                    err = float((k - p).abs().max() / p.abs().max())
                    worst = max(worst, err)
                    ok_a = err <= BIGVGAN_TOL
                else:
                    ok_a = bool(((k - p).abs() <= 2.0 ** -7 * p.abs()
                                 + BIGVGAN_TOL * p.abs().max()).all())
            if not (ok_a and same_v):
                raise AssertionError(
                    f"{'bigvgan_act' if act else 'hifigan_tail'} {label} "
                    f"{kind} ({rows}, {T}, {C}) {dtype}: v equal {same_v}, "
                    f"activation held {ok_a}")
        if act:
            flops, nbytes = ba.bigvgan_act_cost(rows, T, C, 2, operands,
                                                keep_v)
            kernel, plain = ba.bigvgan_act, ba.bigvgan_act_plain
            act_shapes.add((rows, T, C, operands, keep_v, extent, Ty, start))
        else:
            flops, nbytes = ht.hifigan_tail_cost(mode, rows, T, C, 2,
                                                 operands == 3)
            kernel, plain = ht.hifigan_tail, ht.hifigan_tail_plain
            tail_shapes.add((rows, T, C, ht.MODES.index(mode), Ty, start))
        b_ms, b_by = bound_ms(nbytes, flops)
        copy = device_ms(lambda: acc.clone()) if fresh else 0.0
        k_ms = device_ms(lambda: run(kernel)) - copy
        p_ms = device_ms(lambda: run(plain), 10) - copy
        print(f"[kernel] {'bigvgan_act' if act else 'hifigan_tail'} {label} "
              f"{kind}{' +act' if act else ''} ({rows}, {T}, {C}) of "
              f"{extent} rows from {Ty} at {start}, bf16: held | device "
              f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}; {100 * b_ms / k_ms:.1f}% of "
              f"it)")
        return k_ms, p_ms, b_ms

    (rows, T, C, extent, Ty, start), *after = bigvgan_shapes(cfg)
    pre = case("conv_pre", "bias", 1, False, False, rows, T, C, extent, Ty,
               start, False)
    n_stages = len(after) // 2
    for i, (up, mean) in enumerate(zip(after[::2], after[1::2])):
        rows, R, C = up[:3]
        stage = dict(kernel=0.0, plain=0.0, bound=0.0)
        for kind, operands, act, keep_v, count in BIGVGAN_CASES:
            window = {"up": up, "mean": mean}.get(kind, (rows, R, C, R, R, 0))
            ms = case(f"s{i + 1}", kind, operands, act, keep_v, rows,
                      window[1], C, *window[3:], i == n_stages - 1)
            for key, m in zip(("kernel", "plain", "bound"), ms):
                stage[key] += count * m
        print(f"[kernel] bigvgan passes s{i + 1}: a stage's "
              f"{sum(c for *_, c in BIGVGAN_CASES)} passes "
              f"{stage['kernel']:.4f} ms (plain {stage['plain']:.4f} ms), "
              f"bound {stage['bound']:.4f} ms "
              f"({100 * stage['bound'] / stage['kernel']:.1f}%)")
        stages.append(stage)
    total = {k: sum(st[k] for st in stages) + m
             for k, m in zip(("kernel", "plain", "bound"), pre)}
    print(f"[kernel] bigvgan passes: conv_pre's and the stages' passes "
          f"{total['kernel']:.4f} ms a step at {BIGVGAN_LANES} lanes (plain "
          f"{total['plain']:.4f} ms), bound {total['bound']:.4f} ms; worst "
          f"float32 activation error {worst:.3e} of the peak")
    record = dict(max_abs_err=worst, ms=None, plain_ms=None,
                  bound_ms=total["bound"], bound_by="bytes or operations",
                  library_ms=None, device_ms=total["kernel"],
                  plain_device_ms=total["plain"], library_device_ms=None,
                  stage_device_ms=[st["kernel"] for st in stages])
    return record, act_shapes, tail_shapes


def bigvgan_phase(checked: dict[str, set], dev="cuda") -> dict:
    """Phase 22, the bigvgan mode: a captured BatchedServer at
    BIGVGAN_LANES lanes of the published BigVGAN v2 generator (bf16), its
    first step (warm-up and capture) then BIGVGAN_STEPS replays: a pass
    launched once per gap between two convolutions a replay
    (``bigvgan_act`` where an activation follows, ``hifigan_tail``
    elsewhere), as captured and as counted, every shape each was given
    (``launch_shape``) one phase 3 held (``checked``), the output finite
    and not silent.  Returns the phase's launches for the kernels line."""
    import torch
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    cfg = Config.from_dict({"vocoder_mode": "bigvgan"})
    passes, with_act = bigvgan_passes(cfg)
    want = {"bigvgan_act": with_act, "hifigan_tail": passes - with_act}
    kernels = {"bigvgan_act": cuda.BIGVGAN_ACT,
               "hifigan_tail": cuda.HIFIGAN_TAIL}
    shapes, undo = record_shapes()
    cuda.reset_counts()
    try:
        server = BatchedServer(seeded_params(cfg), cfg,
                               num_streams=BIGVGAN_LANES, seed=SEED,
                               vocoder_mode="bigvgan", device=dev)
        S = server.chunk_samples
        xs = lane_signals(BIGVGAN_LANES, BIGVGAN_STEPS + 1, cfg.dsp.in_rate,
                          S)
        server.step(np.ascontiguousarray(xs[:, :S]))
        first = {n: k.launches for n, k in kernels.items()}
        secs, ys = [], []
        for k in range(1, BIGVGAN_STEPS + 1):
            t0 = time.perf_counter()
            ys.append(server.step(np.ascontiguousarray(
                xs[:, k * S: (k + 1) * S])))
            secs.append(time.perf_counter() - t0)
        replays = {n: k.launches - first[n] for n, k in kernels.items()}
        captured = {n: server.program.kernel_launches.get(n, 0)
                    for n in kernels}
        ok = server.captured
        del server
    finally:
        undo()
    launches = launch_counts()
    y = np.stack(ys)
    rms = float(np.sqrt(np.mean(y ** 2)))
    p50, p99 = (float(np.percentile(secs, q)) * 1e3 for q in (50, 99))
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    seen = {n: sorted(set(shapes[n])) for n in kernels}
    unchecked = {n: sorted(set(seen[n]) - checked[n]) for n in kernels}
    print(f"[bigvgan] {BIGVGAN_LANES} lanes captured={ok}: pass launches "
          f"{first} in the first step (warm-up and capture), {replays} in "
          f"{BIGVGAN_STEPS} replays, {captured} as captured (a replay's "
          f"gaps between two convolutions: {passes}, {with_act} with the "
          f"activation); step p50 / p99 {p50:.3f} / {p99:.3f} ms, aggregate "
          f"x{BIGVGAN_LANES * chunk_s * 1e3 / p50:.1f} realtime; output "
          f"finite={bool(np.isfinite(y).all())}, rms {rms:.4f}; "
          f"{sum(len(v) for v in seen.values())} shapes")
    fails = []
    if not ok or captured != want or replays != {
            n: c * BIGVGAN_STEPS for n, c in want.items()}:
        fails.append(f"pass launches {captured} as captured, {replays} in "
                     f"{BIGVGAN_STEPS} replays, expected {want} a replay")
    if any(unchecked.values()):
        fails.append(f"shapes phase 3 did not check: {unchecked}")
    if not np.isfinite(y).all() or rms < 1e-4:
        fails.append(f"output non-finite or silent (rms {rms:.3e})")
    if fails:
        raise AssertionError(f"phase 22 (bigvgan): {fails}")
    torch.cuda.empty_cache()
    return launches


def hifigan_phase(checked: dict[str, set], dev="cuda") -> dict:
    """Phase 22: a captured BatchedServer in the hifigan mode at
    HIFIGAN_LANES lanes of the published generator (bf16), its first step
    (warm-up and capture) then HIFIGAN_STEPS replays: the tail launched
    once per gap between two convolutions a replay, as captured and as
    counted, every shape it was given (``launch_shape``) one phase 3 held
    (``checked``), the output finite and not silent.  Returns the phase's
    launches for the kernels line."""
    import torch
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    cfg = Config.from_dict({"vocoder_mode": "hifigan"})
    tails = hifigan_tails(cfg)
    shapes, undo = record_shapes()
    cuda.reset_counts()
    try:
        server = BatchedServer(seeded_params(cfg), cfg,
                               num_streams=HIFIGAN_LANES, seed=SEED,
                               vocoder_mode="hifigan", device=dev)
        S = server.chunk_samples
        xs = lane_signals(HIFIGAN_LANES, HIFIGAN_STEPS + 1, cfg.dsp.in_rate,
                          S)
        server.step(np.ascontiguousarray(xs[:, :S]))
        first = cuda.HIFIGAN_TAIL.launches
        secs, ys = [], []
        for k in range(1, HIFIGAN_STEPS + 1):
            t0 = time.perf_counter()
            ys.append(server.step(np.ascontiguousarray(
                xs[:, k * S: (k + 1) * S])))
            secs.append(time.perf_counter() - t0)
        replays = cuda.HIFIGAN_TAIL.launches - first
        captured = server.program.kernel_launches.get("hifigan_tail", 0)
        ok = server.captured
        del server
    finally:
        undo()
    launches = launch_counts()
    y = np.stack(ys)
    rms = float(np.sqrt(np.mean(y ** 2)))
    p50, p99 = (float(np.percentile(secs, q)) * 1e3 for q in (50, 99))
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    seen = sorted(set(shapes["hifigan_tail"]))
    unchecked = sorted(set(seen) - checked["hifigan_tail"])
    print(f"[hifigan] {HIFIGAN_LANES} lanes captured={ok}: tail launches "
          f"{first} in the first step (warm-up and capture), {replays} in "
          f"{HIFIGAN_STEPS} replays, {captured} as captured (a replay's "
          f"gaps between two convolutions: {tails}); step p50 / p99 "
          f"{p50:.3f} / {p99:.3f} ms, aggregate "
          f"x{HIFIGAN_LANES * chunk_s * 1e3 / p50:.1f} realtime; output "
          f"finite={bool(np.isfinite(y).all())}, rms {rms:.4f}; shapes "
          f"{seen}")
    fails = []
    if not ok or captured != tails or replays != tails * HIFIGAN_STEPS:
        fails.append(f"tail launches {captured} as captured, {replays} in "
                     f"{HIFIGAN_STEPS} replays, expected {tails} a replay")
    if unchecked:
        fails.append(f"shapes phase 3 did not check: {unchecked}")
    if not np.isfinite(y).all() or rms < 1e-4:
        fails.append(f"output non-finite or silent (rms {rms:.3e})")
    if fails:
        raise AssertionError(f"phase 22: {fails}")
    torch.cuda.empty_cache()
    return launches


def abs_rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, the same relative to max |b|)."""
    err = float((a - b).abs().max())
    return err, err / (float(b.abs().max()) + 1e-30)


class Case(NamedTuple):
    kernel: Callable
    plain: Callable
    library: Callable | None     # one PyTorch call computing the same
    nbytes: float                # each input read once, output written once
    flops: float
    ref64: Callable | None       # the plain chain in float64
    inputs: tuple = ()           # the analysis kernels' tensors


def bank_inputs(R: int, H: int, hop: int, dev, rng):
    """Seeded (aL, aR, phi, frac, g) of the harmonic bank on ``dev``: the
    phase a random start plus a cumulative sum of per-sample advances."""
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    al, ar = t(rng.uniform(0, 0.1, (R, H))), t(rng.uniform(0, 0.1, (R, H)))
    phi = t(rng.uniform(0, 2 * np.pi, (R, 1))
            + np.cumsum(rng.uniform(0.02, 0.2, (R, hop)), axis=1))
    frac = t((np.arange(hop) + 1.0) / hop)
    g = t(rng.standard_normal((R, hop)) * 0.1)
    return al, ar, phi, frac, g


def kernel_cases(R: int, cfg, dev, rng, n: int | None = None):
    """{name: Case} on seeded inputs at the main path's widths with R
    rows; ``n`` overrides the analysis kernels' frame size."""
    import torch
    from realtime_yukarin_tpu_torch.ops import analysis, dft
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    H, hop = cfg.dsp.num_harmonics, cfg.dsp.hop
    n = n or cfg.dsp.fft_size
    K = n // 2 + 1
    al, ar, phi, frac, _ = bank_inputs(R, H, hop, dev, rng)
    frames = t(rng.standard_normal((R, n)) * 0.3)
    P = analysis.power_spectrum_plain(frames, n).contiguous()
    f0 = rng.uniform(80, 300, R)
    lift = t(np.sinc(f0[:, None] * np.arange(K)[None, :]
                     / cfg.dsp.sample_rate))
    db = cfg.dsp.envelope_floor_db
    cs = torch.cat([dft.device_const(dft.rfft_bases, n, like=frames,
                                     index=i) for i in (0, 1)], dim=1)
    C = dft.device_const(dft.cepstrum_basis, n, like=P)
    D = dft.device_const(dft.cepstrum_inverse_basis, n, like=P)
    # (flops, bytes): the formulas a cost count reads (ops/)
    bank_fb = hb.bank_forward_cost(R, H, hop)
    power_fb = analysis.power_spectrum_cost(R, n)
    cep_fb = analysis.envelope_cepstrum_cost(R, K)
    return {
        "harmonic_bank": Case(
            lambda: hb.harmonic_bank(al, ar, phi, frac),
            lambda: hb.harmonic_bank_plain(al, ar, phi, frac),
            None, bank_fb[1], bank_fb[0],
            lambda: hb.harmonic_bank_plain(al.double(), ar.double(),
                                           phi.double(), frac.double())),
        "power_spectrum": Case(
            lambda: analysis.power_spectrum_fused(frames, n),
            lambda: analysis.power_spectrum_plain(frames, n),
            lambda: torch.matmul(frames, cs), power_fb[1], power_fb[0],
            lambda: analysis.power_spectrum_plain(frames.double(), n),
            (frames,)),
        "envelope_cepstrum": Case(
            lambda: analysis.envelope_cepstrum_fused(P, lift, n, db),
            lambda: analysis.envelope_cepstrum_plain(P, lift, n, db),
            lambda: torch.matmul(torch.matmul(torch.matmul(P, C), D), C),
            cep_fb[1], cep_fb[0],
            lambda: analysis.envelope_cepstrum_plain(P.double(),
                                                     lift.double(), n, db),
            (P, lift)),
    }


def bwd_case(R: int, cfg, dev, rng, H: int | None = None,
             hop: int | None = None):
    """(kernel call, plain call, bytes, flops, plain call in float64,
    kernel call for d_aL and d_aR only) of the harmonic-bank backward on
    seeded inputs with R rows, at training's widths unless ``H`` or ``hop``
    is given.  flops and bytes: ``hb.bank_backward_cost``'s (14 FLOP per
    row, sample and harmonic)."""
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb

    H, hop = H or cfg.dsp.num_harmonics, hop or cfg.dsp.hop
    al, ar, phi, frac, g = bank_inputs(R, H, hop, dev, rng)
    nflops, nbytes = hb.bank_backward_cost(R, H, hop)
    return (lambda: hb.harmonic_bank_bwd(al, ar, phi, frac, g),
            lambda: hb.harmonic_bank_bwd_plain(al, ar, phi, frac, g),
            nbytes, nflops,
            lambda: hb.harmonic_bank_bwd_plain(al.double(), ar.double(),
                                               phi.double(), frac.double(),
                                               g.double()),
            lambda: hb._bank_backward(al, ar, phi, frac, g, phase=False))


def bank_ragged(R: int, H: int, hop: int, dev, rng) -> tuple[float, float]:
    """Both bank kernels once at (R, H, hop) against their plain versions:
    (forward error, worst backward output's error), each over the plain
    output's peak."""
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
    al, ar, phi, frac, _ = bank_inputs(R, H, hop, dev, rng)
    _, e_fwd = abs_rel_err(hb.harmonic_bank(al, ar, phi, frac),
                           hb.harmonic_bank_plain(al, ar, phi, frac))
    kern, plain, *_ = bwd_case(R, None, dev, rng, H=H, hop=hop)
    e_bwd = max(abs_rel_err(k, p)[1] for k, p in zip(kern(), plain()))
    return e_fwd, e_bwd


def test_signal(seconds: float, fs: int, seed: int,
                f0_scale: float = 1.0) -> np.ndarray:
    """Seeded voiced / unvoiced alternation over a noise floor: a vibrato
    harmonic stack to 0.9 of Nyquist at -6 dB per octave with AM, bursts
    of louder noise, and the floor alone (-34 dB).  A stack of only a few
    harmonics over a quieter floor leaves most bins of the voiced frames
    near the envelope's -70 dB floor, where float32 rounding moves the
    log envelope (see PERF.md): two float32 orders of summation then
    differ by more than the parity tolerance.  ``f0_scale`` scales the
    contour."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    f0 = f0_scale * (140 + 40 * np.sin(2 * np.pi * 1.3 * t))
    ph = 2 * np.pi * np.cumsum(f0) / fs
    k_max = np.floor(0.9 * fs / 2 / f0)
    voiced = sum(np.where(k <= k_max, np.sin(k * ph) / k, 0.0)
                 for k in range(1, 80))
    seg = (t * 2.5).astype(int) % 4            # 0.4 s segments
    am = 0.3 + 0.1 * np.sin(2 * np.pi * 3.0 * t)
    x = np.where(seg < 2, am * voiced, 0.0)
    x = x + np.where(seg == 2, 0.1 * rng.standard_normal(len(t)), 0.0)
    x = x + 0.01 * rng.standard_normal(len(t))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def seeded_params(cfg):
    """The port's init_params with every weight perturbed by seeded
    noise, so the zero-initialised heads are active."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(cfg, gen)
    with torch.no_grad():
        for net in (params["stage1"], params["stage2"]):
            for p in net.parameters():
                p.add_(PERTURB * torch.randn(p.shape, generator=gen))
    return params


def vocoder_params(cfg):
    """``seeded_params`` with both neural vocoders' leaves perturbed by
    VOCODER_PERTURB too, so the DDSP control net and the wave residual
    are active."""
    import torch
    params = seeded_params(cfg)
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for net in (params["vocoder"], params["vocoder_wave"]):
            for p in net.parameters():
                p.add_(VOCODER_PERTURB * torch.randn(p.shape, generator=gen))
    return params


def perturbed_training_params(cfg):
    """The port's init_params with every leaf of every network perturbed
    by seeded noise, so gradients reach every layer through the heads."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import (NETS,
                                                                 init_params)
    gen = torch.Generator().manual_seed(SEED + 7)
    params = init_params(cfg, gen)
    with torch.no_grad():
        for k in NETS:
            for p in params[k].parameters():
                p.add_(PERTURB * torch.randn(p.shape, generator=gen))
    return params


def snapshot(params) -> dict:
    """{subtree: host copies of its tensors}."""
    from realtime_yukarin_tpu_torch.models.voice_changer import param_leaves
    return {k: [p.detach().cpu().clone() for p in ps]
            for k, ps in param_leaves(params).items()}


def moved(before: dict, after: dict) -> dict:
    """{subtree: whether any of its tensors changed}."""
    return {k: any(not bool((a == b).all()) for a, b in zip(ps, after[k]))
            for k, ps in before.items()}


def train_phase(cfg, dev) -> dict:
    """TRAIN_STEPS joint steps, then TRAIN_STEPS GAN steps, each on a fresh
    batch made on ``dev``.  Returns {step wall times, steps}."""
    import torch
    from realtime_yukarin_tpu_torch.models.discriminator import (
        init_discriminator)
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    from realtime_yukarin_tpu_torch.training import train_step as ts
    from realtime_yukarin_tpu_torch.training.data import make_batch

    seconds = TRAIN_FRAMES * cfg.dsp.hop / cfg.dsp.sample_rate
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                              torch.Generator().manual_seed(SEED + 1))
    runs = (("joint", ts.init_train_state(params, dev),
             ts.make_train_step(cfg)),
            ("gan", ts.init_gan_train_state(params, disc, dev),
             ts.make_gan_train_step(cfg)))
    walls = {}
    for name, state, step_fn in runs:
        before = snapshot(state.params)
        if name == "gan":
            before["discriminator"] = snapshot(
                {"d": state.d_params})["d"]
        walls[name] = []
        for s in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = make_batch(cfg, TRAIN_BATCH, seconds=seconds,
                               seed=SEED + s, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            m = {k: float(v) for k, v in m.items()}
            walls[name].append((t1 - t0, t2 - t1))
            print(f"[train] {name} step {s + 1}: "
                  + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items()))
                  + f" | make_batch {(t1 - t0) * 1e3:.1f} ms, step "
                  f"{(t2 - t1) * 1e3:.1f} ms")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{name} step {s + 1}: non-finite "
                                     f"losses {m}")
        after = snapshot(state.params)
        if name == "gan":
            after["discriminator"] = snapshot({"d": state.d_params})["d"]
        # f0_stats get zero gradient; their AdamW decay (lr 1e-4 x 1e-5)
        # is below float32 resolution, as in the JAX package
        did = moved(before, after)
        print(f"[train] {name}: subtrees moved {did}")
        stuck = [k for k, v in did.items() if not v and k != "f0_stats"]
        if stuck:
            raise AssertionError(f"{name}: subtrees did not move: {stuck}")
    return {"walls": walls, "steps": 2 * TRAIN_STEPS}


def wave_render(net, batch, cfg, mesh=None):
    """(the wave decoder's render of ``batch``, the training step's term
    that reads it: 0.5 * multi_resolution_stft against the real wave, over
    the global batch when ``mesh`` splits it)."""
    from realtime_yukarin_tpu_torch.models.vocoder_wave import (
        waveform_vocode)
    from realtime_yukarin_tpu_torch.training import losses
    b = batch
    wave, _ = waveform_vocode(net, b.f0_voc, b.env_voc, b.ap_voc, b.mc_voc,
                              b.noise, cfg.vocoder_wave, cfg.dsp)
    return wave, 0.5 * losses.multi_resolution_stft(wave, b.wave_voc,
                                                    mesh=mesh)


def grad_error(d: list, c: list) -> tuple[float, float, float]:
    """(max |d - c| / max |c|, the peak, cosine of the flattened lists)."""
    import torch
    a = torch.cat([x.detach().cpu().flatten() for x in d]).double()
    b = torch.cat([x.detach().flatten() for x in c]).double()
    peak = float(b.abs().max())
    err = float((a - b).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    return (err / peak if peak > 0 else err), peak, cos


def train_parity(cfg, dev) -> dict:
    """One step's losses and gradients on ``dev`` and on the CPU from the
    same weights and batch; the wave decoder leaf by leaf.  Returns the
    measured errors."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import (
        params_trainable)
    from realtime_yukarin_tpu_torch.training import train_step as ts
    from realtime_yukarin_tpu_torch.training.data import make_batch

    params = perturbed_training_params(cfg)
    batch = make_batch(cfg, 2, seconds=TRAIN_FRAMES * cfg.dsp.hop
                       / cfg.dsp.sample_rate, seed=SEED + 11, device="cpu")
    p_c, p_d = params_trainable(params, "cpu"), params_trainable(params, dev)
    m_c, g_c = ts.loss_and_grads(p_c, batch, cfg)
    m_d, g_d = ts.loss_and_grads(p_d, batch.to(dev), cfg)
    out = {"loss": max(abs(float(m_d[k]) - float(m_c[k]))
                       / max(abs(float(m_c[k])), 1e-12) for k in m_c)}
    print("[train-parity] losses cuda / cpu: " + ", ".join(
        f"{k} {float(m_d[k]):.6f} / {float(m_c[k]):.6f}" for k in m_c))
    fails = [] if out["loss"] <= PARITY_LOSS_TOL else ["losses"]
    for k, tol in PARITY_GRAD_TOL.items():
        rel, peak, cos = grad_error(g_d[k], g_c[k])
        out[f"grad_{k}"] = rel
        print(f"[train-parity] step gradient {k}: max_err/peak {rel:.3e} "
              f"(peak {peak:.3e}, cosine {cos:.6f}), tol {tol:g}")
        if rel > tol:
            fails.append(k)
    # f0_stats: zero on both, the loss does not read them
    # the wave decoder: the CUDA step's cotangent replayed through the CPU
    # render; the step gradient on CUDA is J_cuda^T c_cuda
    wave_d, term_d = wave_render(p_d["vocoder_wave"], batch.to(dev), cfg)
    c_d = torch.autograd.grad(term_d, wave_d)[0]
    wave_c, term_c = wave_render(p_c["vocoder_wave"], batch, cfg)
    c_c = torch.autograd.grad(term_c, wave_c, retain_graph=True)[0]
    names, leaves = zip(*p_c["vocoder_wave"].named_parameters())
    at_cd = torch.autograd.grad(wave_c, list(leaves),
                                grad_outputs=c_d.cpu())
    rel, peak, cos = grad_error([c_d], [c_c])
    print(f"[train-parity] vocoder_wave loss cotangent d term / d render: "
          f"max_err/peak {rel:.3e} (peak {peak:.3e}, cosine {cos:.6f}), "
          f"not held (tools/torch_wave_grad_conditioning.py)")
    out["wave_leaf"] = 0.0
    for name, gd, gc, gx in zip(names, g_d["vocoder_wave"],
                                g_c["vocoder_wave"], at_cd):
        r_step, _, c_step = grad_error([gd], [gc])
        r_leaf, peak, c_leaf = grad_error([gd], [gx])
        tol = PARITY_WAVE_TOL.get(name, PARITY_WAVE_LEAF_TOL)
        out["wave_leaf"] = max(out["wave_leaf"], r_leaf)
        print(f"[train-parity] vocoder_wave {name}: step gradient cuda vs "
              f"cpu {r_step:.3e} of the peak (cosine {c_step:.6f}); at the "
              f"CUDA step's cotangent {r_leaf:.3e} (peak {peak:.3e}, cosine "
              f"{c_leaf:.6f}), tol {tol:g}")
        if r_leaf > tol:
            fails.append(f"vocoder_wave {name}")
    print(f"[train-parity] losses max rel err {out['loss']:.3e} (tol "
          f"{PARITY_LOSS_TOL:g}); {'ok' if not fails else fails}")
    if fails:
        raise AssertionError(f"CUDA and CPU training steps disagree: "
                             f"{fails}")
    return out


def run_stream(params, cfg, x, device, vocoder_mode="dsp"):
    """Feed ``x`` chunk by chunk, then flush.  Returns (output trimmed to
    the input timeline, per-chunk seconds, voicing per step, steps)."""
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
    stream = VoiceChangerStream(params, cfg, seed=SEED, device=device,
                                vocoder_mode=vocoder_mode)
    S = stream.chunk_samples
    outs, secs, voicing = [], [], []
    for k in range(len(x) // S):
        t0 = time.perf_counter()
        stream.add(x[k * S: (k + 1) * S])
        outs.append(stream.process())
        sync(device)
        secs.append(time.perf_counter() - t0)
        voicing.append(stream.final_f0() > 0)
    tail = stream.flush()
    steps = len(x) // S + len(tail) // S
    y = np.concatenate(outs + [tail])
    lat = stream.latency_samples
    return y[lat: lat + len(x)], np.asarray(secs), np.stack(voicing), steps


def launch_counts() -> dict:
    """Launches per kernel of the port: either design of the power
    spectrum and of the envelope cepstrum counts as its kernel
    (``CudaKernel.computes``); ``design_counts`` tells them apart."""
    from realtime_yukarin_tpu_torch.ops import cuda
    counts: dict[str, int] = {}
    for k in cuda.KERNELS:
        counts[k.computes] = counts.get(k.computes, 0) + k.launches
    return counts


def design_counts() -> dict:
    """Launches per CUDA kernel, each design of kernels 2 and 3 apart."""
    from realtime_yukarin_tpu_torch.ops import cuda
    return {k.name: k.launches for k in cuda.KERNELS}


def require_launches(label: str, launches: dict, at_least: int) -> None:
    """Raise unless every forward kernel launched ``at_least`` times."""
    short = {k: launches[k] for k in FORWARD_KERNELS
             if launches[k] < at_least}
    if short:
        raise AssertionError(f"{label}: kernels launched fewer than "
                             f"{at_least} times: {short}")


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def offline_phase(cfg, params, x, dev) -> dict:
    """Phase 8: offline_convert on ``dev`` in every vocoder mode (bf16),
    then ``dev`` vs the CPU in float32.  Returns {mode: launches}."""
    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.pipeline import (offline_analyze,
                                                     offline_convert)
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        noise_key_from_seed)

    hop = cfg.dsp.hop
    F = len(x) // hop
    key = noise_key_from_seed(SEED)
    p_dev = params_to(params, dev)
    seconds = len(x) / cfg.dsp.sample_rate
    launches = {}
    for mode in VOCODER_MODES:
        t0 = time.perf_counter()
        offline_convert(p_dev, x, key, cfg, F, vocoder_mode=mode,
                        device=dev)
        sync(dev)
        first = time.perf_counter() - t0
        walls = []
        for rep in range(3):
            if rep == 2:
                cuda.reset_counts()
            t0 = time.perf_counter()
            y = offline_convert(p_dev, x, key, cfg, F, vocoder_mode=mode,
                                device=dev).cpu().numpy()
            walls.append(time.perf_counter() - t0)
            if rep == 2:
                launches[mode] = launch_counts()
        wall = float(np.median(walls))
        rms = float(np.sqrt(np.mean(y ** 2)))
        print(f"[offline] {mode}: {F} frames, out {y.shape[0]} samples, "
              f"finite={bool(np.isfinite(y).all())}, rms {rms:.4f} | wall "
              f"{wall * 1e3:.2f} ms (median of 3; first call "
              f"{first * 1e3:.1f} ms), x{seconds / wall:.1f} realtime | "
              f"launches {launches[mode]}")
        if y.shape != (F * hop,) or not np.isfinite(y).all() or rms < 1e-3:
            raise AssertionError(f"offline {mode}: output wrong-sized, "
                                 f"non-finite or silent")
        require_launches(f"offline {mode}", launches[mode], 1)
    # CUDA vs CPU, float32 models
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p_cpu = params_to(params, "cpu")
    vc = offline_analyze(x, cfg32, F, device=dev).f0.cpu().numpy() > 0
    vh = offline_analyze(x, cfg32, F, device="cpu").f0.numpy() > 0
    same_voicing = bool((vc == vh).all())
    fails = [] if same_voicing else ["voicing"]
    for mode in VOCODER_MODES:
        yc = offline_convert(p_dev, x, key, cfg32, F, vocoder_mode=mode,
                             device=dev).cpu().numpy()
        yh = offline_convert(p_cpu, x, key, cfg32, F, vocoder_mode=mode,
                             device="cpu").numpy()
        err = float(np.abs(yc - yh).max() / (np.abs(yh).max() + 1e-9))
        print(f"[offline-parity] {mode} cuda vs cpu: max_err/peak="
              f"{err:.3e} (tol 2e-3), voicing identical={same_voicing} "
              f"({int(vh.sum())} voiced of {vh.size} frames)")
        if err > 2e-3:
            fails.append(mode)
    if fails:
        raise AssertionError(f"offline CUDA and CPU disagree: {fails}")
    return launches


def stream_vs_offline_phase(cfg, params, x, dev) -> None:
    """Phase 9: in float32 on ``dev``, the streamed output of each
    vocoder mode against offline_convert on the interior; the wave
    residual is checked to be active."""
    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.pipeline import offline_convert
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        noise_key_from_seed)
    from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    hop = cfg.dsp.hop
    F = len(x) // hop
    p_dev = params_to(params, dev)
    offline = {}
    fails = []
    for mode in VOCODER_MODES:
        offline[mode] = offline_convert(
            p_dev, x, noise_key_from_seed(SEED), cfg32, F,
            vocoder_mode=mode, device=dev).cpu().numpy()
        streamed = run_stream(params, cfg32, x, dev, mode)[0]
        geo = StreamGeometry.from_config(cfg32, vocoder_mode=mode)
        lo, hi = ((geo.model_ctx + 2) * hop, (F - geo.model_ctx - 2) * hop)
        a, b = offline[mode][lo:hi], streamed[lo:hi]
        err = float(np.abs(b - a).max() / (np.abs(a).max() + 1e-9))
        tol = STREAM_OFFLINE_TOL[mode]
        print(f"[stream-offline] {mode}: streamed vs offline on samples "
              f"[{lo}, {hi}): max_err/peak={err:.3e} (tol {tol:g})")
        if err > tol:
            fails.append(mode)
    residual = float(np.abs(offline["wave"] - offline["dsp"]).max())
    print(f"[stream-offline] wave residual max |wave - dsp| = "
          f"{residual:.3e} (must exceed 1e-3)")
    if residual <= 1e-3:
        fails.append("wave residual inactive")
    if fails:
        raise AssertionError(f"streamed != offline on the card: {fails}")


def streams_phase(cfg, params, dev) -> dict:
    """Phase 10: the ddsp and wave streaming modes and a CLIENT_RATE in /
    out client (bf16) on ``dev``.  Returns {label: launches}."""
    from realtime_yukarin_tpu_torch.ops import cuda
    rate_cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=CLIENT_RATE, output_rate=CLIENT_RATE))
    runs = (("ddsp", cfg, "ddsp"), ("wave", cfg, "wave"),
            (f"{CLIENT_RATE // 1000} kHz client", rate_cfg, "dsp"))
    launches = {}
    for label, c, mode in runs:
        x = test_signal(SECONDS, c.dsp.in_rate, SEED)
        cuda.reset_counts()
        y, secs, _, steps = run_stream(params, c, x, dev, mode)
        launches[label] = launch_counts()
        chunk_s = c.streaming.chunk_samples(c.dsp) / c.dsp.sample_rate
        p50, p99 = (float(np.percentile(secs[1:], q)) for q in (50, 99))
        rms = float(np.sqrt(np.mean(y ** 2)))
        print(f"[streams] {label}: {steps} steps, out {y.shape[0]} samples "
              f"(in {x.shape[0]}), finite={bool(np.isfinite(y).all())}, "
              f"rms {rms:.4f}, launches {launches[label]}")
        print(f"[streams] {label}: chunk wall time p50 {p50 * 1e3:.3f} ms "
              f"p99 {p99 * 1e3:.3f} ms (first chunk {secs[0] * 1e3:.1f} "
              f"ms), x{chunk_s / p50:.1f} realtime for one stream at p50")
        if (y.shape[0] != x.shape[0] or not np.isfinite(y).all()
                or rms < 1e-3):
            raise AssertionError(f"{label} stream output is wrong-sized, "
                                 f"non-finite or silent")
        require_launches(label, launches[label], steps)
    return launches


# -- batched serving and the host edges (phases 12-16) -----------------------

@functools.lru_cache(maxsize=1)
def lane_signals(n: int, steps: int, fs: int, S: int) -> np.ndarray:
    """[n, steps * S] seeded lane inputs: test_signal per lane with its own
    seed, f0 scale (0.8-1.2) and gain (0.3-1.7); lanes i % 9 == 3 are
    silent."""
    x = np.zeros((n, steps * S), np.float32)
    for i in range(n):
        if i % 9 == 3:
            continue
        sig = test_signal(steps * S / fs + 0.01, fs, SEED + i,
                          f0_scale=0.8 + 0.4 * (i % 8) / 7)
        x[i] = sig[: steps * S] * (0.3 + 1.4 * ((i * 37) % 64) / 63)
    return x


def record_shapes() -> tuple[dict, Callable[[], None]]:
    """Wrap each kernel's count to record the shape it was given
    (``launch_shape``; the launch still counts once): an eager launch, or
    a launch a captured graph replays (``ops/cuda.py``); returns ({name:
    [shape, ...]}, undo), by the kernel each launch computes (either design
    of kernels 2 and 3 under its kernel's name)."""
    from realtime_yukarin_tpu_torch.ops import cuda
    shapes = {k.computes: [] for k in cuda.KERNELS}
    for k in cuda.KERNELS:
        def count(args, _k=k):
            shapes[_k.computes].append(launch_shape(_k.computes, args))
            type(_k).count(_k, args)
        k.count = count

    def undo():
        for k in cuda.KERNELS:
            del k.count
    return shapes, undo


def lane_masks(N: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Phase 12's (live, reset) masks [N] at step ``k``: PAUSED_LANE paused
    over PAUSE_STEPS, RESET_LANE reset at RESET_STEP."""
    live = np.ones(N, bool)
    live[PAUSED_LANE] = not PAUSE_STEPS[0] <= k <= PAUSE_STEPS[1]
    reset = np.zeros(N, bool)
    reset[RESET_LANE] = k == RESET_STEP
    return live, reset


def single_run(params, cfg, key, chunks: np.ndarray):
    """A VoiceChangerStream with noise ``key`` over [steps, S] chunks:
    (output [steps * So], voicing [steps, Fc])."""
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
    stream = VoiceChangerStream(params, cfg, noise_key=key, device="cuda")
    outs, voicing = [], []
    for c in chunks:
        stream.add(c)
        outs.append(stream.process())
        voicing.append(stream.final_f0() > 0)
    return np.concatenate(outs), np.stack(voicing)


def rel_peak(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def batched_phase(cfg) -> dict:
    """Phase 12: BATCH_STREAMS lanes in float32 through one BatchedServer
    for BATCH_STEPS steps; lanes held to single streams, a paused lane's
    carry bit for bit, a reset lane against a fresh stream, one launch of
    each forward kernel per step at R = 20 * BATCH_STREAMS, and a step
    with no host synchronisation.  Returns the run's launches, its output
    [steps, N, So] and every lane's voicing [steps, N, Fc] (phase 18's
    reference)."""
    import torch
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        lane_noise_keys)
    from realtime_yukarin_tpu_torch.streaming.state import tree_leaves

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = seeded_params(cfg32)
    N, steps = BATCH_STREAMS, BATCH_STEPS
    server = BatchedServer(params, cfg32, num_streams=N, seed=SEED,
                           device="cuda")
    S, Fc = server.chunk_samples, cfg.streaming.chunk_frames(cfg.dsp)
    x = lane_signals(N, LANE_STEPS, cfg.dsp.in_rate, S)[:, : steps * S]
    chunks = x.reshape(N, steps, S).transpose(1, 0, 2)       # [steps, N, S]
    keys = lane_noise_keys(SEED, N)
    held = [i for i in BATCH_HELD if i not in (PAUSED_LANE, RESET_LANE)]
    outs, voicing = [], []
    cuda.reset_counts()
    shapes, undo = record_shapes()
    try:
        for k in range(steps):
            live, reset = lane_masks(N, k)
            if k == PAUSE_STEPS[0]:
                before = [t.clone() for t in
                          tree_leaves(server.lane_carry(PAUSED_LANE))]
            outs.append(server.step(chunks[k], live=live, reset=reset))
            if k == PAUSE_STEPS[1]:
                after = tree_leaves(server.lane_carry(PAUSED_LANE))
                same = all(torch.equal(a, b) for a, b in zip(before, after))
            voicing.append(torch.stack([
                server.lane_carry(i).f0_cache[-Fc:] > 0
                for i in range(N)]).cpu().numpy())
    finally:
        undo()
    launches = launch_counts()
    rows = {k: [s[0] for s in shapes[k]] for k in FORWARD_KERNELS}
    out = np.stack(outs)                                     # [steps, N, So]
    paused = out[PAUSE_STEPS[0]: PAUSE_STEPS[1] + 1, PAUSED_LANE]
    R = 20 * N
    print(f"[batched] {N} streams x {steps} steps (float32): launches "
          f"{launches} (by design {design_counts()}); rows per launch "
          f"{ {k: sorted(set(v)) for k, v in rows.items()} }")
    print(f"[batched] lane {PAUSED_LANE} paused for steps {PAUSE_STEPS}: "
          f"carry bit-equal={same} ({len(before)} leaves), output max "
          f"{float(np.abs(paused).max()):.3e}")
    fails = []
    for name in FORWARD_KERNELS:
        if launches[name] != steps or set(rows[name]) != {R}:
            fails.append(f"{name}: {launches[name]} launches, rows "
                         f"{sorted(set(rows[name]))}")
    if not same or np.abs(paused).max() != 0.0:
        fails.append(f"paused lane {PAUSED_LANE}")
    for lane in held:
        y, v = single_run(params, cfg32, keys[lane], chunks[:, lane])
        vb = np.stack(voicing)[:, lane]
        err = rel_peak(out[:, lane].reshape(-1), y)
        same_v = bool((vb == v).all())
        print(f"[batched] lane {lane} vs a single stream: max_err/peak="
              f"{err:.3e} (tol {BATCH_TOL:g}), voicing identical={same_v} "
              f"({int(v.sum())} voiced of {v.size} frames)")
        if err > BATCH_TOL or not same_v:
            fails.append(f"lane {lane}")
    y, _ = single_run(params, cfg32, keys[RESET_LANE],
                      chunks[RESET_STEP:, RESET_LANE])
    err = rel_peak(out[RESET_STEP:, RESET_LANE].reshape(-1), y)
    print(f"[batched] lane {RESET_LANE} reset at step {RESET_STEP} vs a "
          f"fresh stream from there: max_err/peak={err:.3e}")
    if err > BATCH_TOL:
        fails.append(f"reset lane {RESET_LANE}")
    # one step of device tensors with sync debugging set to raise
    xs = torch.from_numpy(chunks[0]).cuda()
    server.step_device(xs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        server.step_device(xs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[batched] step_device under set_sync_debug_mode('error'): no "
          "host synchronisation")
    if fails:
        raise AssertionError(f"batched serving: {fails}")
    return launches, out, np.stack(voicing)


# a record_function span's name ("Optimizer.step#AdamW.step"); kernel names
# carry templates, scopes and parentheses
ANNOTATION = re.compile(r"^[\w.]+#[\w.]+$")
# the host's calls that put work on the device: kernel and graph launches,
# copies, fills
LAUNCH_API = re.compile(r"^cu(da)?(LaunchKernel\w*|GraphLaunch|Memcpy\w*|"
                        r"Memset\w*)$")


def profile_stats(fn, n: int) -> dict:
    """``torch.profiler`` over ``n`` calls of ``fn`` (ending in a sync):
    host ms per call, device busy ms per call (every GPU kernel and copy
    summed; one stream, so they do not overlap), idle share, GPU launches
    per call, the host's launch, copy and fill calls per call
    (LAUNCH_API), each port kernel's (device us per launch, launches per
    call), {GPU event name: [device us, ...]} and the GPU events as
    (name, start us, end us) (``ops``).  The GPU-side spans of
    user annotations overlap the kernels they contain and are left out.
    CUPTI lists a replayed CUDA graph's kernels one by one
    (``lists_replays`` checks it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from realtime_yukarin_tpu_torch.ops import cuda
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not ANNOTATION.match(e.name)]
    by_name: dict[str, list] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    busy = sum(e.device_time for e in events) / 1e3
    port = {}
    for kname in dict.fromkeys(k.computes for k in cuda.KERNELS):
        # csrc/<name>.cu's kernel is <name>_kernel, demangled as
        # "<name>_kernel<" or "<name>_kernel(" (csrc/<name>_wide.cu's is
        # wide::<name>_kernel: either design)
        t = [us for name, ts in by_name.items()
             if any(f"{kname}_kernel{c}" in name for c in "<(")
             for us in ts]
        port[kname] = (float(np.mean(t)) if t else None, len(t) / n)
    host_launches = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and LAUNCH_API.match(e.name))
    return dict(wall_ms=wall * 1e3 / n, busy_ms=busy / n,
                idle=(1.0 - busy / (wall * 1e3)) if events else None,
                gpu_launches=len(events) / n,
                host_launches=host_launches / n, port=port, by_name=by_name,
                ops=[(e.name, e.time_range.start, e.time_range.end)
                     for e in events])


def throughput_phase(cfg) -> dict:
    """Phase 13: bf16 BatchedServer at each of SERVE_STREAMS: p50 / p99
    step wall time (host clock; host chunks in, host output back, so each
    step ends in a device sync), aggregate x realtime, the forward kernels'
    launches per step, and a profiler window's device busy, idle share,
    GPU launches and port-kernel device time.  Returns {N: record}."""
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer

    params = seeded_params(cfg)
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    out = {}
    for N in SERVE_STREAMS:
        server = BatchedServer(params, cfg, num_streams=N, seed=SEED,
                               device="cuda")
        S = server.chunk_samples
        chunks = lane_signals(BATCH_STREAMS, LANE_STEPS, cfg.dsp.in_rate,
                              S)[:N].reshape(N, LANE_STEPS, S).transpose(
                                  1, 0, 2).copy()
        feed = iter(chunks)
        for _ in range(SERVE_WARMUP):
            server.step(next(feed))
        cuda.reset_counts()
        walls = []
        for _ in range(SERVE_STEPS):
            t0 = time.perf_counter()
            y = server.step(next(feed))
            walls.append(time.perf_counter() - t0)
        if not np.isfinite(y).all():
            raise AssertionError(f"serving N={N}: non-finite output")
        per_step = {k: n / SERVE_STEPS for k, n in launch_counts().items()}
        stats = profile_stats(lambda: server.step(next(feed)), PROFILE_STEPS)
        p50, p99 = (float(np.percentile(walls, q)) for q in (50, 99))
        stats.pop("by_name")
        rec = dict(p50_ms=p50 * 1e3, p99_ms=p99 * 1e3,
                   x_realtime=N * chunk_s / p50, launches=per_step, **stats)
        out[N] = rec
        port = ", ".join(
            f"{k} {us:.2f} us x{c:g}" if us is not None
            else f"{k} not measured" for k, (us, c) in stats["port"].items()
            if k in FORWARD_KERNELS)
        print(f"[serve] N={N}: step wall p50 {rec['p50_ms']:.3f} ms p99 "
              f"{rec['p99_ms']:.3f} ms, aggregate x{rec['x_realtime']:.1f} "
              f"realtime; port kernel launches/step "
              f"{ {k: per_step[k] for k in FORWARD_KERNELS} }")
        print(f"[serve] N={N} profile ({PROFILE_STEPS} steps): host "
              f"{stats['wall_ms']:.3f} ms/step, device busy "
              f"{stats['busy_ms']:.3f} ms/step, idle share "
              + (f"{stats['idle']:.3f}" if stats["idle"] is not None
                 else "not measured")
              + f", {stats['gpu_launches']:.1f} GPU launches/step; device per "
              f"launch: {port}")
        if any(per_step[k] != 1 for k in FORWARD_KERNELS):
            raise AssertionError(f"serving N={N}: forward kernels not "
                                 f"launched once per step: {per_step}")
        del server
    return out


class SocketClients:
    """Connect to ``srv`` one client at a time, each after the last was
    accepted (so client i holds slot i), then stream every signal at once;
    ``run()`` returns each client's converted PCM."""

    def __init__(self, srv, signals):
        import socket
        self._socks = []
        for i in range(len(signals)):
            s = socket.create_connection(srv.address)
            deadline = time.time() + 60
            while srv.metrics.counters.get("accepted_connections", 0) <= i:
                if time.time() > deadline:
                    raise AssertionError("the socket server accepts no "
                                         "connection")
                time.sleep(0.01)
            self._socks.append(s)
        self._data = [np.ascontiguousarray(x, "<f4").tobytes()
                      for x in signals]

    def run(self) -> list[np.ndarray]:
        import socket
        import threading
        outs = [bytearray() for _ in self._socks]

        def client(i):
            s = self._socks[i]

            def pump():
                s.sendall(self._data[i])
                s.shutdown(socket.SHUT_WR)
            t = threading.Thread(target=pump, daemon=True)
            t.start()
            while True:
                b = s.recv(65536)
                if not b:
                    break
                outs[i].extend(b)
            t.join()
            s.close()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(self._socks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("a socket client did not finish")
        return [np.frombuffer(bytes(o), "<f4") for o in outs]


def socket_phase(cfg) -> None:
    """Phase 14: SocketVoiceServer on the card (float32): SOCKET_STREAMS
    slots serving SOCKET_CLIENTS concurrent clients, then a CLIENT_RATE in
    / out server with one client; each output against a single stream
    with its slot's noise key."""
    from realtime_yukarin_tpu_torch.runtime.socket_server import (
        SocketVoiceServer)
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        lane_noise_keys)
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    rate_cfg = dataclasses.replace(cfg32, dsp=dataclasses.replace(
        cfg.dsp, input_rate=CLIENT_RATE, output_rate=CLIENT_RATE))
    params = seeded_params(cfg32)
    fails = []
    for label, c, n_clients in (("24 kHz", cfg32, SOCKET_CLIENTS),
                                (f"{CLIENT_RATE // 1000} kHz", rate_cfg, 1)):
        fs = c.dsp.in_rate
        signals = [test_signal(SOCKET_SECONDS, fs, SEED + 11 + i)
                   * (0.6 + 0.3 * i) for i in range(n_clients)]
        t0 = time.perf_counter()
        with SocketVoiceServer(params, c, num_streams=SOCKET_STREAMS,
                               seed=SEED, device="cuda") as srv:
            ready = time.perf_counter() - t0
            ys = SocketClients(srv, signals).run()
            counters = dict(srv.metrics.counters)
            lat = srv.metrics.chunk_latency.summary()
        keys = lane_noise_keys(SEED, SOCKET_STREAMS)
        for i, (x, y) in enumerate(zip(signals, ys)):
            stream = VoiceChangerStream(params, c, noise_key=keys[i],
                                        device="cuda")
            stream.add(x)
            ref = np.concatenate([stream.process(), stream.flush()])
            n = min(len(ref), len(y))
            err = rel_peak(y[:n], ref[:n])
            print(f"[socket] {label} client {i} (slot {i}): {len(y)} "
                  f"samples back for {len(x)}, finite="
                  f"{bool(np.isfinite(y).all())}, vs a single stream "
                  f"max_err/peak={err:.3e} (tol {BATCH_TOL:g})")
            if n < len(x) or err > BATCH_TOL or not np.isfinite(y).all():
                fails.append(f"{label} client {i}")
        print(f"[socket] {label}: server ready in {ready:.2f} s; ticker "
              f"step p50 {lat.get('p50', float('nan')):.2f} ms p99 "
              f"{lat.get('p99', float('nan')):.2f} ms; counters {counters}")
        if counters.get("output_overruns", 0) or counters.get(
                "ticker_errors", 0):
            fails.append(f"{label} counters {counters}")
    if fails:
        raise AssertionError(f"socket serving: {fails}")


def pipelined_phase(cfg) -> None:
    """Phase 15: PipelinedStream (depth 2, bf16) on the card equals the
    synchronous VoiceChangerStream bit for bit on SECONDS of signal; then
    a SOAK_CHUNKS-chunk soak: finite, nothing dropped, output rms of the
    first and the last 10 s within 25% of each other."""
    from realtime_yukarin_tpu_torch.runtime.pipelined import PipelinedStream
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

    params = seeded_params(cfg)
    x = test_signal(SECONDS, cfg.dsp.in_rate, SEED)
    sync = VoiceChangerStream(params, cfg, seed=SEED, device="cuda")
    sync.add(x)
    ref = np.concatenate([sync.process(), sync.flush()])
    with PipelinedStream(params, cfg, seed=SEED, depth=2,
                         device="cuda") as pipe:
        pipe.push_input(x)
        pipe.flush()
        got = pipe.pop_output(pipe.output_available())
    n = min(len(ref), len(got))
    same = n >= len(x) and bool(np.array_equal(got[:n], ref[:n]))
    print(f"[pipelined] depth 2 vs synchronous on {len(x)} samples: "
          f"bit-equal={same}")
    if not same:
        raise AssertionError("PipelinedStream differs from the synchronous "
                             "stream")
    fs = cfg.dsp.in_rate
    with PipelinedStream(params, cfg, seed=SEED, depth=2, ring_seconds=2.0,
                         device="cuda") as ps:
        S, So = ps.chunk_samples, ps.chunk_out_samples
        src = test_signal(10.0, fs, SEED + 5)
        got, pushed = [], 0
        t0 = time.perf_counter()
        for k in range(SOAK_CHUNKS):
            c = src[(k * S) % (len(src) - S):][:S]
            while len(c):
                m = ps.push_input(c)
                pushed += m
                c = c[m:]
                if len(c):
                    time.sleep(0.001)
            if ps.output_available():
                got.append(ps.pop_output(ps.output_available()))
        deadline = time.time() + 120
        while (sum(map(len, got)) < SOAK_CHUNKS * So
               and time.time() < deadline):
            if ps.output_available():
                got.append(ps.pop_output(ps.output_available()))
            else:
                time.sleep(0.002)
        wall = time.perf_counter() - t0
        counters = dict(ps.metrics.counters)
        m = ps.metrics.to_dict()
    y = np.concatenate(got)
    ten_s = 100 * So
    rms = [float(np.sqrt(np.mean(seg ** 2)))
           for seg in (y[:ten_s], y[SOAK_CHUNKS * So - ten_s:
                                   SOAK_CHUNKS * So])]
    d, c = m["dispatch_latency_ms"], m["chunk_latency_ms"]
    print(f"[pipelined] soak {SOAK_CHUNKS} chunks in {wall:.1f} s: "
          f"{len(y)} samples back, finite={bool(np.isfinite(y).all())}, "
          f"rms first / last 10 s {rms[0]:.4f} / {rms[1]:.4f}; dispatch "
          f"p50 {d['p50']:.3f} ms p99 {d['p99']:.3f} ms, chunk latency p50 "
          f"{c['p50']:.3f} ms p99 {c['p99']:.3f} ms; counters {counters}")
    if (pushed != SOAK_CHUNKS * S or len(y) < SOAK_CHUNKS * So
            or not np.isfinite(y).all() or min(rms) < 1e-3
            or abs(rms[1] - rms[0]) > 0.25 * max(rms)
            or counters.get("output_underruns", 0)):
        raise AssertionError("pipelined soak failed")


def first_chunk_phase(cfg) -> None:
    """Phase 16: a CLIENT_RATE in / out stream's creation (which captures
    its program) and first chunk, with every host constant and resample
    matrix built anew (as in a fresh process), FIRST_CHUNK_RUNS times."""
    import torch
    from realtime_yukarin_tpu_torch.dsp import resample
    from realtime_yukarin_tpu_torch.ops import dft
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

    rate_cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=CLIENT_RATE, output_rate=CLIENT_RATE))
    params = seeded_params(rate_cfg)
    totals = []
    for run in range(FIRST_CHUNK_RUNS):
        dft._const.cache_clear()
        resample._matrix_np.cache_clear()
        t0 = time.perf_counter()
        stream = VoiceChangerStream(params, rate_cfg, seed=SEED,
                                    device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream.add(test_signal(0.1, CLIENT_RATE, SEED))
        y = stream.process()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        totals.append(t2 - t0)
        print(f"[first-chunk] {CLIENT_RATE // 1000} kHz client, run {run}: "
              f"stream created in {t1 - t0:.3f} s (both resample matrices "
              f"built, its program captured in "
              f"{stream.program.capture_s:.3f} s), first chunk "
              f"{t2 - t1:.3f} s, together {t2 - t0:.3f} s; output "
              f"{len(y)} samples")
        if len(y) != stream.chunk_out_samples or not np.isfinite(y).all():
            raise AssertionError("48 kHz first chunk wrong-sized or "
                                 "non-finite")
        del stream
    print(f"[first-chunk] creation plus first chunk over {FIRST_CHUNK_RUNS} "
          f"runs: {min(totals):.3f}-{max(totals):.3f} s")


# -- the corpus training path and the quality recipe (phase 17) -------------

# Phase 17 (a): CORPUS_PAIRS seeded formant pairs of CORPUS_SECONDS source /
# target audio, prepared at the CLI's default bucket (R = 600 / 800 rows per
# analysis launch); (b) cli.train at the default Config in float32 on them
CORPUS_PAIRS, CORPUS_SECONDS, CORPUS_BUCKET = 16, (3.0, 3.3), 200
CORPUS_STEPS, CORPUS_FINETUNE = 3, 3
# DTW: CUDA and CPU paths of one pair identical, or, where they part, both
# paths' costs under the CUDA cost matrix within this (relative)
DTW_COST_TOL = 1e-5
# (c): tools/torch_quality.py's recipe: training and fine-tune steps
QUALITY_STEPS, QUALITY_FINETUNE = 600, 300
QUALITY_JSON = "QUALITY.json"


def _npz(path) -> dict:
    with np.load(path) as z:
        return dict(z)


def _wav_pairs(root, n: int, fs: int) -> tuple:
    """Write n seeded formant pairs (the quality corpus's two speakers at
    CORPUS_SECONDS); returns (src dir, tgt dir, seconds of audio)."""
    import pathlib
    from realtime_yukarin_tpu_torch.training.data import (SRC_SPEAKER,
                                                          TGT_SPEAKER,
                                                          formant_utterance)
    from realtime_yukarin_tpu_torch.utils.audio_io import write_wav
    src, tgt = pathlib.Path(root) / "src", pathlib.Path(root) / "tgt"
    src.mkdir()
    tgt.mkdir()
    rng = np.random.default_rng(SEED + 11)
    s_src, s_tgt = CORPUS_SECONDS
    for k in range(n):
        write_wav(str(src / f"utt{k:02d}.wav"),
                  formant_utterance(k, rng, s_src, fs, **SRC_SPEAKER), fs)
        write_wav(str(tgt / f"utt{k:02d}.wav"),
                  formant_utterance(k, rng, s_tgt, fs, **TGT_SPEAKER), fs)
    return src, tgt, n * (s_src + s_tgt)


def prepare_phase(cfg, root, dev) -> tuple[dict, object]:
    """Phase 17 (a): prepare CORPUS_PAIRS pairs on the card (timed, the
    DTW's share timed apart), then one pair again on the CPU against it.
    Returns (launches, prepared dir)."""
    import pathlib
    import shutil
    import torch
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.pipeline import cached_programs
    from realtime_yukarin_tpu_torch.training import align, corpus

    src, tgt, audio_s = _wav_pairs(root, CORPUS_PAIRS, cfg.dsp.sample_rate)
    out = pathlib.Path(root) / "prep"
    dtw_s = []
    align_pair = corpus.align_pair

    def timed_align(*a):
        sync(dev)
        t = time.perf_counter()
        r = align_pair(*a)
        sync(dev)
        dtw_s.append(time.perf_counter() - t)
        return r

    corpus.align_pair = timed_align
    before = set(map(id, cached_programs()))
    try:
        cuda.reset_counts()
        t0 = time.perf_counter()
        corpus.prepare_corpus(str(src), str(tgt), str(out), cfg,
                              bucket_frames=CORPUS_BUCKET, verbose=False,
                              device=dev)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        corpus.align_pair = align_pair
    # each analysis program built here (a bucket length's second file) ran
    # its body once more, eagerly, to warm up
    built = [p.name for p in cached_programs() if id(p) not in before]
    rows = sorted({corpus.frame_bucket(int(s * cfg.dsp.sample_rate)
                                       // cfg.dsp.hop, CORPUS_BUCKET)
                   for s in CORPUS_SECONDS})
    print(f"[prepare] {CORPUS_PAIRS} pairs ({audio_s:.1f} s of audio) in "
          f"{wall:.3f} s: x{audio_s / wall:.1f} audio seconds per second; "
          f"DTW {sum(dtw_s):.3f} s ({sum(dtw_s) / wall:.3f} of the wall, "
          f"{np.mean(dtw_s) * 1e3:.1f} ms per pair); launches {launches}; "
          f"analysis rows per launch {rows}; programs built {built}")
    for k in ("power_spectrum", "envelope_cepstrum"):
        if launches[k] != 2 * CORPUS_PAIRS + len(built):
            raise AssertionError(f"{k} launched {launches[k]} times for "
                                 f"{2 * CORPUS_PAIRS} files and {len(built)} "
                                 f"warm-ups")
    stats = {n: _npz(out / f"stats_{n}.npz") for n in ("input", "target")}
    print("[prepare] F0 stats " + ", ".join(
        f"{n}: mean {float(s['mean']):.4f} std {float(s['std']):.4f}"
        for n, s in stats.items()))

    # one pair again on the CPU (the plain versions), against the card's
    one = pathlib.Path(root) / "one"
    for d, name in ((src, "src"), (tgt, "tgt")):
        (one / name).mkdir(parents=True)
        shutil.copy(d / "utt00.wav", one / name / "utt00.wav")
    corpus.prepare_corpus(str(one / "src"), str(one / "tgt"),
                          str(one / "prep"), cfg,
                          bucket_frames=CORPUS_BUCKET, verbose=False,
                          device="cpu")
    c, h = _npz(out / "utt00.npz"), _npz(one / "prep" / "utt00.npz")
    errs = {}
    for side in ("src", "voc"):
        if not ((c[f"f0_{side}"] > 0) == (h[f"f0_{side}"] > 0)).all():
            raise AssertionError(f"prepare cuda vs cpu: {side} voicing "
                                 f"differs")
        for k in ("f0", "mc", "ap", "env"):
            errs[f"{k}_{side}"] = rel_peak(c[f"{k}_{side}"],
                                           h[f"{k}_{side}"])
    paths = {}
    for name, d, on in (("cuda", c, dev), ("cpu", h, "cpu")):
        paths[name] = align.dtw_path(
            torch.from_numpy(d["mc_src"][:, 1:]).to(on),
            torch.from_numpy(d["mc_voc"][:, 1:]).to(on)).cpu().numpy()
    same_path = bool((paths["cuda"] == paths["cpu"]).all())
    C = align.cost_matrix(torch.from_numpy(c["mc_src"][:, 1:]).to(dev),
                          torch.from_numpy(c["mc_voc"][:, 1:]).to(dev)
                          ).cpu().numpy()
    cost = {k: align.path_cost(C, p) for k, p in paths.items()}
    cost_rel = abs(cost["cuda"] - cost["cpu"]) / abs(cost["cuda"])
    print(f"[prepare] utt00 cuda vs cpu: voicing identical, /peak "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol 2e-3); DTW paths identical={same_path} "
          f"({int((paths['cuda'] != paths['cpu']).sum())} of "
          f"{len(paths['cpu'])} frames apart), path costs under the CUDA "
          f"matrix {cost['cuda']:.6g} / {cost['cpu']:.6g} (rel "
          f"{cost_rel:.3e}, tol {DTW_COST_TOL:g})")
    if max(errs.values()) > 2e-3:
        raise AssertionError(f"prepare cuda vs cpu: features apart {errs}")
    if not same_path and cost_rel > DTW_COST_TOL:
        raise AssertionError(f"prepare cuda vs cpu: DTW paths part and "
                             f"their costs differ by {cost_rel:.3e}")
    if same_path:
        for k in ("f0", "mc", "ap", "env"):
            e = rel_peak(c[f"{k}_tgt"], h[f"{k}_tgt"])
            if e > 2e-3:
                raise AssertionError(f"prepare cuda vs cpu: {k}_tgt {e}")
    return launches, out


def corpus_train_phase(cfg, prep, root, dev) -> dict:
    """Phase 17 (b): ``cli.train --prepared_dir`` at the default Config in
    float32, then ``--finetune_converted`` and ``--export_params``.
    Returns the launches."""
    import contextlib
    import io
    import pathlib
    import torch
    from realtime_yukarin_tpu_torch.cli import train as train_cli
    from realtime_yukarin_tpu_torch.models import voice_changer as vc
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.training import checkpoint, train_step

    root = pathlib.Path(root)
    cfg_path = root / "float32.yaml"
    cfg_path.write_text("compute_dtype: float32\n")
    out, ckpt = root / "params.npz", root / "ckpt"
    argv = ["--prepared_dir", str(prep), "--steps", str(CORPUS_STEPS),
            "--batch_size", str(TRAIN_BATCH), "--crop_frames",
            str(TRAIN_FRAMES), "--log_every", "1", "--config_path",
            str(cfg_path), "--ckpt_dir", str(ckpt), "--finetune_converted",
            str(CORPUS_FINETUNE), "--export_params", str(out), "--device",
            str(dev)]
    cuda.reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        train_cli.main(argv)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for line in log.getvalue().splitlines():
        print(line)
    losses = [float(m.group(1)) for m in re.finditer(
        r"step \d+/\d+ .*?\bloss=(\S+)", log.getvalue())]
    steps = CORPUS_STEPS + CORPUS_FINETUNE
    print(f"[corpus-train] cli.train {' '.join(argv[:2])} ... in {wall:.1f} "
          f"s: {CORPUS_STEPS} steps + {CORPUS_FINETUNE} fine-tune steps, "
          f"losses {losses}; launches {launches}")
    if len(losses) != CORPUS_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"corpus training losses {losses}")
    for k in ("harmonic_bank", "harmonic_bank_bwd"):
        if launches[k] < steps:
            raise AssertionError(f"{k} launched {launches[k]} times in "
                                 f"{steps} steps")
    # the trained tree (the checkpoint at the last step) and the export
    run_cfg = type(cfg).from_yaml(cfg_path)
    init = vc.init_params(run_cfg, torch.Generator().manual_seed(
        run_cfg.seed))
    state, at = checkpoint.restore_checkpoint(
        ckpt, train_step.init_train_state(init, "cpu"))
    trained = vc.params_to_jax(state.params)
    exported = vc.params_to_jax(vc.load_params_npz(str(out), run_cfg))
    start = vc.params_to_jax(init)

    def subtree_moved(a, b):
        return {s: any(not np.array_equal(a[n], b[n]) for n in a
                       if n.startswith(s + "/")) for s in vc.NETS}

    by_training = subtree_moved(start, trained)
    by_finetune = subtree_moved(trained, exported)
    same_stats = all(np.array_equal(trained[n], exported[n])
                     for n in trained if n.startswith("f0_stats/"))
    print(f"[corpus-train] checkpoint at step {at}; moved by training "
          f"{by_training}; moved by the fine-tune {by_finetune}; f0_stats "
          f"kept {same_stats}")
    if at != CORPUS_STEPS or not all(by_training.values()):
        raise AssertionError("corpus training left a subtree unmoved")
    if (by_finetune != {"stage1": False, "stage2": False, "vocoder": True,
                        "vocoder_wave": True} or not same_stats):
        raise AssertionError("the fine-tune moved other than both "
                             "vocoders")
    return launches


def _distance(doc, ref, path="") -> list[str]:
    """'path: value (QUALITY.json value, difference)' for every number
    both documents hold."""
    if isinstance(doc, dict):
        return [line for k in doc if isinstance(ref, dict) and k in ref
                for line in _distance(doc[k], ref[k], f"{path}/{k}")]
    if isinstance(doc, (int, float)) and isinstance(ref, (int, float)) \
            and not isinstance(doc, bool):
        return [f"{path}: {doc:.4f} (QUALITY.json {ref:.4f}, "
                f"{doc - ref:+.4f})"]
    return []


def quality_phase(root, dev) -> tuple[dict, float]:
    """Phase 17 (c): tools/torch_quality.py's recipe on the card, gated
    with the JAX package's held-out gates.  Returns (the launches, the
    recipe's wall seconds)."""
    import pathlib
    import torch
    from realtime_yukarin_tpu_torch.ops import cuda

    repo = pathlib.Path(__file__).resolve().parent
    tq = torch_quality()

    cuda.reset_counts()
    t0 = time.perf_counter()
    doc = tq.run_quality(
        dev, QUALITY_STEPS, QUALITY_FINETUNE, pathlib.Path(root) / "quality",
        log=lambda m: print(m.replace("[quality]", "[quality] recipe:")))
    sync(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    print(json.dumps(doc))
    ref = json.loads((repo / QUALITY_JSON).read_text())
    for line in _distance(doc, ref):
        print(f"[quality] {line}")
    gates = tq.quality_gates(doc)
    for what, ok in gates:
        print(f"[quality] {'ok  ' if ok else 'FAIL'} {what}")
    print(f"[quality] recipe in {wall:.1f} s; launches {launches}")
    failed = [w for w, ok in gates if not ok]
    if failed:
        raise AssertionError(f"quality gates failed: {failed}")
    missing = [k for k in TPU_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the quality recipe launched no {missing}")
    return launches, wall


def corpus_phase(cfg, dev, checked: dict[str, set]
                 ) -> tuple[dict[str, dict], float]:
    """Phase 17: (a) prepare, (b) train at full width, fine-tune and
    export, (c) the quality recipe.  Every shape the phase gives a kernel
    must be one that phase 3 held against the plain version (``checked``).
    Returns (each part's launches, the quality recipe's wall seconds)."""
    import collections
    import tempfile
    out = {}
    shapes, undo = record_shapes()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as root:
            t0 = time.perf_counter()
            out["prepare"], prep = prepare_phase(cfg, root, dev)
            print(f"[prepare] phase seconds {time.perf_counter() - t0:.1f}")
            t0 = time.perf_counter()
            out["train"] = corpus_train_phase(cfg, prep, root, dev)
            print(f"[corpus-train] phase seconds "
                  f"{time.perf_counter() - t0:.1f}")
            t0 = time.perf_counter()
            out["quality"], quality_s = quality_phase(root, dev)
            print(f"[quality] phase seconds {time.perf_counter() - t0:.1f}")
    finally:
        undo()
    unchecked = {}
    for name, seen in shapes.items():
        count = collections.Counter(seen)
        print(f"[corpus] {name}: launches per shape "
              + ", ".join(f"{s}: {n}" for s, n in sorted(count.items())))
        if set(count) - checked[name]:
            unchecked[name] = sorted(set(count) - checked[name])
    if unchecked:
        raise AssertionError(f"phase 17 gave kernels shapes that phase 3 "
                             f"did not hold against the plain versions: "
                             f"{unchecked}")
    print("[corpus] every shape of phase 17 was held against the plain "
          "version in phase 3")
    return out, quality_s


# -- two ranks on one card over torch.distributed (phase 18) ----------------

def mh_serving(cfg, dev) -> dict:
    """A rank's share of phase 12's run: BATCH_STREAMS lanes in float32 over
    the process group, this rank feeding its ``local_slots`` through
    ``step_local`` under phase 12's schedule."""
    import torch
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    server = BatchedServer(seeded_params(cfg32), cfg32,
                           num_streams=BATCH_STREAMS, seed=SEED, device=dev)
    N, steps, S = BATCH_STREAMS, BATCH_STEPS, server.chunk_samples
    lo, hi = server.local_slots.start, server.local_slots.stop
    Fc = cfg.streaming.chunk_frames(cfg.dsp)
    x = lane_signals(N, LANE_STEPS, cfg.dsp.in_rate, S)[lo:hi, : steps * S]
    chunks = x.reshape(hi - lo, steps, S).transpose(1, 0, 2)
    outs, voicing = [], []
    for k in range(steps):
        live, reset = lane_masks(N, k)
        outs.append(server.step_local(chunks[k], live=live[lo:hi],
                                      reset=reset[lo:hi]))
        voicing.append(torch.stack([
            server.lane_carry(i).f0_cache[-Fc:] > 0
            for i in range(hi - lo)]).cpu().numpy())
    return {"out": np.stack(outs), "voicing": np.stack(voicing),
            "slots": np.asarray([lo, hi])}


def mh_serve_timing(cfg, dev) -> dict:
    """bf16 BatchedServer over the process group at BATCH_STREAMS lanes,
    both ranks stepping at once (a barrier first): this rank's p50 / p99
    step wall time, lanes, launches per step and a profiler window."""
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.multihost import sync_hosts
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer

    server = BatchedServer(seeded_params(cfg), cfg,
                           num_streams=BATCH_STREAMS, seed=SEED, device=dev)
    S, (lo, hi) = server.chunk_samples, (server.local_slots.start,
                                         server.local_slots.stop)
    feed = iter(lane_signals(BATCH_STREAMS, LANE_STEPS, cfg.dsp.in_rate,
                             S)[lo:hi].reshape(hi - lo, LANE_STEPS, S)
                .transpose(1, 0, 2).copy())
    for _ in range(SERVE_WARMUP):
        server.step_local(next(feed))
    sync_hosts()
    cuda.reset_counts()
    walls = []
    for _ in range(SERVE_STEPS):
        t0 = time.perf_counter()
        y = server.step_local(next(feed))
        walls.append(time.perf_counter() - t0)
    if not np.isfinite(y).all():
        raise AssertionError("bf16 serving: non-finite output")
    per_step = {k: n / SERVE_STEPS for k, n in launch_counts().items()}
    stats = profile_stats(lambda: server.step_local(next(feed)),
                          PROFILE_STEPS)
    stats.pop("by_name")
    return dict(p50_ms=float(np.percentile(walls, 50)) * 1e3,
                p99_ms=float(np.percentile(walls, 99)) * 1e3,
                lanes=hi - lo, launches=per_step, **stats)


def mh_batches(cfg, dev, rank: int):
    """Phase 18's training batch of ``rank`` (TRAIN_BATCH x TRAIN_FRAMES,
    ``cli.train``'s per-rank seed)."""
    from realtime_yukarin_tpu_torch.cli.train import RANK_SEED_STRIDE
    from realtime_yukarin_tpu_torch.training.data import make_batch
    return make_batch(cfg, TRAIN_BATCH,
                      seconds=TRAIN_FRAMES * cfg.dsp.hop / cfg.dsp.sample_rate,
                      seed=SEED + 21 + rank * RANK_SEED_STRIDE, device=dev)


def cat_batches(batches):
    import torch
    from realtime_yukarin_tpu_torch.training.train_step import Batch
    return Batch(**{f.name: torch.cat([getattr(b, f.name) for b in batches])
                    for f in dataclasses.fields(Batch)})


def mh_train(cfg, run_dir, dev) -> tuple[dict, dict]:
    """MH_TRAIN_STEPS joint steps at model_parallel 1 (this rank's half of
    the batch), then as many at model_parallel 2 (the whole batch, the
    weights split), both from phase 7's weights.  Returns ({M: losses per
    step}, arrays): each run's first gradient (model shards gathered,
    summed over the data ranks) and this rank's part of the wave
    decoder's loss cotangent there."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import param_leaves
    from realtime_yukarin_tpu_torch.parallel.mesh import (gather_model,
                                                          make_mesh,
                                                          sharded_leaf_ids)
    from realtime_yukarin_tpu_torch.parallel.multihost import process_index
    from realtime_yukarin_tpu_torch.training import train_step as ts

    halves = [ts.Batch(**torch.load(pathlib.Path(run_dir) / f"batch_{r}.pt",
                                    weights_only=True)).to(dev)
              for r in range(MH_RANKS)]
    params = perturbed_training_params(cfg)
    losses, arrays = {}, {}
    for M in (1, MH_RANKS):
        mesh = make_mesh(M)
        batch = (halves[process_index()] if M == 1 else cat_batches(halves))
        step, shard = ts.make_sharded_train_step(cfg, mesh)
        state = shard(ts.init_train_state(params, dev))
        _, grads = ts.loss_and_grads(state.params, batch, cfg, mesh)
        split = sharded_leaf_ids(state.params)
        for k, ps in param_leaves(state.params).items():
            for i, (p, g) in enumerate(zip(ps, grads[k])):
                g = gather_model(g, mesh, 0) if id(p) in split else g
                arrays[f"M{M}/grad/{k}/{i}"] = g.cpu().numpy()
        wave, term = wave_render(state.params["vocoder_wave"], batch, cfg,
                                 mesh)
        arrays[f"M{M}/cotangent"] = torch.autograd.grad(
            term, wave)[0].cpu().numpy()
        losses[M] = []
        for _ in range(MH_TRAIN_STEPS):
            state, m = step(state, batch)
            losses[M].append({k: float(v) for k, v in m.items()})
    return losses, arrays


def mh_socket(cfg, dev) -> dict:
    """This rank's SocketVoiceServer (float32, its half of
    MH_SOCKET_STREAMS slots) and one client on it."""
    from realtime_yukarin_tpu_torch.parallel.multihost import process_index
    from realtime_yukarin_tpu_torch.runtime.socket_server import (
        SocketVoiceServer, convert_over_socket)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with SocketVoiceServer(seeded_params(cfg32), cfg32,
                           num_streams=MH_SOCKET_STREAMS, seed=SEED,
                           device=dev) as srv:
        x = mh_socket_signal(cfg32, process_index())
        y = convert_over_socket(*srv.address, x)
        return {"out": y, "slot": np.asarray(srv._server.local_slots.start)}


def mh_socket_signal(cfg, rank: int) -> np.ndarray:
    return test_signal(MH_SOCKET_SECONDS, cfg.dsp.in_rate, SEED + 31 + rank)


def mh_nccl_helpers(dev) -> None:
    """The layout's collectives on the card over the NCCL group of one
    rank: a model gather, a data-group sum, a split layer."""
    import copy

    import torch
    import torch.distributed as dist
    from realtime_yukarin_tpu_torch.models.acoustic import conv1d_valid
    from realtime_yukarin_tpu_torch.parallel.mesh import (Mesh, gather_model,
                                                          sum_over_data_)

    world = dist.group.WORLD
    mesh = Mesh(0, 1, 1, data_group=world, model_group=world)
    t = torch.arange(12.0, device=dev).reshape(3, 4)
    if not torch.equal(gather_model(t, mesh, 0), t):
        raise AssertionError("NCCL gather over one rank changed the tensor")
    u = t.clone()
    sum_over_data_([u], mesh)
    if not torch.equal(u, t):
        raise AssertionError("NCCL sum over one rank changed the tensor")
    conv = torch.nn.Conv1d(4, 6, 3).to(dev)
    split = copy.deepcopy(conv)
    split.model_shard = mesh             # a model group of one rank
    x = torch.randn(2, 10, 4, device=dev)
    if not torch.equal(conv1d_valid(x, split, torch.float32),
                       conv1d_valid(x, conv, torch.float32)):
        raise AssertionError("a split conv over one NCCL rank differs")


def multihost_worker(mode: str, rank: int, world: int, port: int,
                     run_dir: str, device: str) -> int:
    """A rank of phase 18 (this script run with MH_FLAG): joins the group
    on ``device`` (gloo ranks, or the NCCL rank of a group of one), runs
    its part at the parent's Config (``config.json``), writes its numbers,
    arrays and kernel launch shapes to ``run_dir``."""
    import datetime

    import torch
    import torch.distributed as dist
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.multihost import (
        init_multihost, sync_hosts)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if mode == "nccl":
        # a group of one: init_multihost treats one process as no group
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
            rank=0, device_id=torch.device("cuda", 0),
            timeout=datetime.timedelta(seconds=MH_GROUP_TIMEOUT_S))
    else:
        init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                       device=dev, timeout_s=MH_GROUP_TIMEOUT_S)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise AssertionError("the process group is not the one asked for")
    cfg = Config.from_dict(json.loads(
        (pathlib.Path(run_dir) / "config.json").read_text()))
    rec = {"backend": dist.get_backend()}
    arrays = {}
    shapes, undo = record_shapes()
    try:
        cuda.reset_counts()
        served = mh_serving(cfg, dev)
        rec["serve_launches"] = launch_counts()
        arrays.update({f"serve/{k}": v for k, v in served.items()})
        if mode == "nccl":
            mh_nccl_helpers(dev)
        else:
            rec["timing"] = mh_serve_timing(cfg, dev)
            cuda.reset_counts()
            rec["losses"], train_arrays = mh_train(cfg, run_dir, dev)
            rec["train_launches"] = launch_counts()
            arrays.update(train_arrays)
            arrays.update({f"socket/{k}": v
                           for k, v in mh_socket(cfg, dev).items()})
    finally:
        undo()
    rec["shapes"] = {k: sorted(set(v)) for k, v in shapes.items()}
    tag = f"{mode}_{rank}"
    np.savez(pathlib.Path(run_dir) / f"{tag}.npz", **arrays)
    (pathlib.Path(run_dir) / f"{tag}.json").write_text(json.dumps(rec))
    sync_hosts()
    dist.destroy_process_group()
    print(f"[multihost] worker {tag} done", flush=True)
    return 0


def mh_run(run_dir, mode: str, world: int, dev) -> list[dict]:
    """Run phase 18's ``mode`` workers (``world`` processes on this card)
    and wait; raise if any fails or outlasts MH_TIMEOUT_S.  Returns each
    rank's record with its arrays under ``"arrays"``."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(pathlib.Path(run_dir) / f"{mode}_{r}.log", "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), MH_FLAG,
         mode, str(r), str(world), str(port), str(run_dir), str(dev)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        deadline = time.monotonic() + MH_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(
            f"--- {mode} rank {r}:\n" + (pathlib.Path(run_dir)
                                         / f"{mode}_{r}.log")
            .read_text()[-3000:] for r in failed)
        raise AssertionError(f"phase 18: {mode} ranks {failed} failed "
                             f"(exit {[procs[r].returncode for r in failed]})"
                             f"\n{tails}")
    out = []
    for r in range(world):
        rec = json.loads((pathlib.Path(run_dir) / f"{mode}_{r}.json")
                         .read_text())
        with np.load(pathlib.Path(run_dir) / f"{mode}_{r}.npz") as f:
            rec["arrays"] = dict(f)
        out.append(rec)
    return out


def mh_check_serving(label: str, ranks: list[dict], ref_out, ref_voicing,
                     fails: list) -> None:
    """Each rank's rows against phase 12's one-process run."""
    for r, rec in enumerate(ranks):
        a = rec["arrays"]
        lo, hi = (int(v) for v in a["serve/slots"])
        got, ref = a["serve/out"], ref_out[:, lo:hi]
        err = rel_peak(got.reshape(-1), ref.reshape(-1))
        same_v = bool((a["serve/voicing"] == ref_voicing[:, lo:hi]).all())
        paused = (PAUSED_LANE in range(lo, hi) and np.abs(
            got[PAUSE_STEPS[0]: PAUSE_STEPS[1] + 1, PAUSED_LANE - lo]
        ).max() == 0.0)
        print(f"[multihost] {label} rank {r}: slots [{lo}, {hi}) of "
              f"{BATCH_STREAMS} vs one process (phase 12): max_err/peak="
              f"{err:.3e} (tol {BATCH_TOL:g}), bit-equal="
              f"{bool(np.array_equal(got, ref))}, voicing identical="
              f"{same_v}" + (f", paused lane {PAUSED_LANE} silent={paused}"
                             if PAUSED_LANE in range(lo, hi) else ""))
        if err > BATCH_TOL or not same_v or (
                PAUSED_LANE in range(lo, hi) and not paused):
            fails.append(f"{label} serving rank {r}")


def mh_reference_train(cfg, dev, batch, cotangents: dict) -> dict:
    """One process on the whole batch from phase 7's weights: the first
    gradient, the wave decoder's leaves at each run's own cotangent
    (J^T c, phase 7's way), and MH_TRAIN_STEPS steps' losses."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import param_leaves
    from realtime_yukarin_tpu_torch.training import train_step as ts

    state = ts.init_train_state(perturbed_training_params(cfg), dev)
    _, grads = ts.loss_and_grads(state.params, batch, cfg)
    wave = wave_render(state.params["vocoder_wave"], batch, cfg)[0]
    leaves = param_leaves(state.params)["vocoder_wave"]
    at = {M: torch.autograd.grad(wave, leaves, retain_graph=True,
                                 grad_outputs=torch.from_numpy(c).to(dev))
          for M, c in cotangents.items()}
    del wave        # its graph: no autograd graph over the state may stay
    step = ts.make_train_step(cfg)      # alive when the step is captured
    losses = []
    for _ in range(MH_TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append({k: float(v) for k, v in m.items()})
    return {"grads": grads, "wave_at": at, "losses": losses,
            "names": [n for n, _ in state.params["vocoder_wave"]
                      .named_parameters()]}


def mh_check_train(ranks: list[dict], ref: dict, fails: list) -> None:
    """Losses (PARITY_LOSS_TOL relative, every step, every rank alike),
    the first gradients of stage 1, stage 2 and the DDSP vocoder
    (PARITY_GRAD_TOL of each subtree's peak), the wave decoder's leaves at
    the run's own cotangent (PARITY_WAVE_TOL / PARITY_WAVE_LEAF_TOL)."""
    import torch
    for M in (1, MH_RANKS):
        a = ranks[0]["arrays"]
        for s in range(MH_TRAIN_STEPS):
            got = [rec["losses"][str(M)][s] for rec in ranks]
            rel = max(abs(got[0][k] - v) / max(abs(v), 1e-12)
                      for k, v in ref["losses"][s].items())
            alike = all(g == got[0] for g in got)
            print(f"[multihost] train model_parallel {M} step {s + 1}: "
                  f"loss {got[0]['loss']:.6f} vs one process "
                  f"{ref['losses'][s]['loss']:.6f}, max rel err {rel:.3e} "
                  f"(tol {PARITY_LOSS_TOL:g}), ranks alike={alike}")
            if rel > PARITY_LOSS_TOL or not alike:
                fails.append(f"train M={M} step {s + 1} losses")
        for k, tol in PARITY_GRAD_TOL.items():
            got = [torch.from_numpy(a[f"M{M}/grad/{k}/{i}"])
                   for i in range(len(ref["grads"][k]))]
            rel, peak, cos = grad_error(got, [g.cpu() for g in
                                              ref["grads"][k]])
            print(f"[multihost] train model_parallel {M} first gradient "
                  f"{k}: max_err/peak {rel:.3e} (peak {peak:.3e}, cosine "
                  f"{cos:.6f}), tol {tol:g}")
            if rel > tol:
                fails.append(f"train M={M} gradient {k}")
        worst = 0.0
        for i, name in enumerate(ref["names"]):
            g = torch.from_numpy(a[f"M{M}/grad/vocoder_wave/{i}"])
            r_leaf, _, _ = grad_error([g], [ref["wave_at"][M][i].cpu()])
            tol = PARITY_WAVE_TOL.get(name, PARITY_WAVE_LEAF_TOL)
            worst = max(worst, r_leaf / tol)
            if r_leaf > tol:
                fails.append(f"train M={M} vocoder_wave {name}")
        print(f"[multihost] train model_parallel {M} vocoder_wave leaves at "
              f"the run's own cotangent: worst error {worst:.3f} of its "
              f"tolerance")


def mh_reference_socket(cfg, dev) -> list[np.ndarray]:
    """Each rank's client served by one process: a SocketVoiceServer whose
    layout puts it at that rank's place (``Mesh(r, MH_RANKS, 1)``: the same
    global slots, lane keys and lanes per step, no process group), so
    its client lands on the same global slot."""
    from realtime_yukarin_tpu_torch.parallel.mesh import Mesh
    from realtime_yukarin_tpu_torch.runtime.socket_server import (
        SocketVoiceServer, convert_over_socket)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = []
    for r in range(MH_RANKS):
        with SocketVoiceServer(seeded_params(cfg32), cfg32,
                               num_streams=MH_SOCKET_STREAMS, seed=SEED,
                               device=dev, mesh=Mesh(r, MH_RANKS, 1)) as srv:
            out.append(convert_over_socket(*srv.address,
                                           mh_socket_signal(cfg32, r)))
    return out


def multihost_phase(cfg, dev, checked: dict[str, set], batched_out,
                    batched_voicing) -> dict[str, dict]:
    """Phase 18: (a) serving over two gloo ranks on this card against
    phase 12's one process, the same over one NCCL rank, and both ranks'
    bf16 timing; (b) sharded training at model_parallel 1 and 2 against
    one process on the whole batch; (c) one socket client per rank against
    one process.  Every kernel shape the ranks launched must be one phase
    3 held.  Returns the ranks' launches on the paths."""
    import tempfile

    import torch
    fails = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multihost_") as d:
        halves = [mh_batches(cfg, dev, r) for r in range(MH_RANKS)]
        for r, b in enumerate(halves):
            torch.save({f.name: getattr(b, f.name).cpu()
                        for f in dataclasses.fields(b)},
                       pathlib.Path(d) / f"batch_{r}.pt")
        t0 = time.perf_counter()
        (pathlib.Path(d) / "config.json").write_text(
            json.dumps(cfg.to_dict()))
        gloo = mh_run(d, "gloo", MH_RANKS, dev)
        print(f"[multihost] gloo ranks: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        nccl = mh_run(d, "nccl", 1, dev)
        print(f"[multihost] NCCL rank: {time.perf_counter() - t0:.1f} s, "
              f"backend {nccl[0]['backend']}")
    mh_check_serving("gloo", gloo, batched_out, batched_voicing, fails)
    mh_check_serving("nccl", nccl, batched_out, batched_voicing, fails)
    for r, rec in enumerate(gloo):
        t = rec["timing"]
        print(f"[multihost] bf16 rank {r} ({t['lanes']} lanes, both ranks "
              f"at once): step wall p50 {t['p50_ms']:.3f} ms p99 "
              f"{t['p99_ms']:.3f} ms; launches/step "
              f"{ {k: t['launches'][k] for k in FORWARD_KERNELS} }; "
              f"profile host {t['wall_ms']:.3f} ms/step, device busy "
              f"{t['busy_ms']:.3f} ms/step, idle share "
              + (f"{t['idle']:.3f}" if t["idle"] is not None
                 else "not measured"))
        if any(t["launches"][k] != 1 for k in FORWARD_KERNELS):
            fails.append(f"bf16 rank {r}: launches {t['launches']}")
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    agg = sum(rec["timing"]["lanes"] * chunk_s / rec["timing"]["p50_ms"]
              * 1e3 for rec in gloo)
    print(f"[multihost] bf16 aggregate x{agg:.1f} realtime over both ranks "
          f"({BATCH_STREAMS} lanes; phase 13 is one process at "
          f"{BATCH_STREAMS})")

    batch = cat_batches(halves)
    ref = mh_reference_train(cfg, dev, batch, {
        1: np.concatenate([rec["arrays"]["M1/cotangent"] for rec in gloo]),
        MH_RANKS: gloo[0]["arrays"][f"M{MH_RANKS}/cotangent"]})
    mh_check_train(gloo, ref, fails)
    for r, rec in enumerate(gloo):
        tl = rec["train_launches"]
        print(f"[multihost] train rank {r}: launches {tl}")
        if min(tl["harmonic_bank"], tl["harmonic_bank_bwd"]) < \
                2 * MH_TRAIN_STEPS:
            fails.append(f"train rank {r}: kernels 1 and 4 not launched in "
                         f"every step: {tl}")

    refs = mh_reference_socket(cfg, dev)
    for r, rec in enumerate(gloo):
        y, slot = rec["arrays"]["socket/out"], int(rec["arrays"]["socket/slot"])
        same = len(y) == len(refs[r]) and bool(np.array_equal(y, refs[r]))
        n = min(len(y), len(refs[r]))
        err = rel_peak(y[:n], refs[r][:n]) if n else float("inf")
        print(f"[multihost] socket rank {r} client (global slot {slot}): "
              f"{len(y)} samples, bit-equal to one process={same} "
              f"(max_err/peak {err:.3e})")
        if not same:
            fails.append(f"socket rank {r}")

    unchecked = {}
    for rec in gloo + nccl:
        for name, seen in rec["shapes"].items():
            extra = {tuple(x) for x in seen} - checked[name]
            if extra:
                unchecked.setdefault(name, set()).update(extra)
    print("[multihost] kernel shapes launched: " + "; ".join(
        f"{name} {sorted({tuple(x) for rec in gloo + nccl for x in rec['shapes'][name]})}"
        for name in checked))
    if unchecked:
        fails.append(f"shapes phase 3 did not check: {unchecked}")
    if fails:
        raise AssertionError(f"phase 18: {fails}")
    print("[multihost] every shape of phase 18 was held against the plain "
          "version in phase 3")
    return {f"{mode} rank {r} {part}": rec[f"{part}_launches"]
            for mode, recs in (("gloo", gloo), ("nccl", nccl))
            for r, rec in enumerate(recs)
            for part in ("serve", "train") if f"{part}_launches" in rec}


# -- the captured programs (phase 19) ---------------------------------------

def leaves_equal(a, b) -> bool:
    """Whether two carries hold the same tensors bit for bit."""
    import torch
    from realtime_yukarin_tpu_torch.streaming.state import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def low_latency_config(cfg):
    """bench.py's 20 ms profile (bench.py:380-396) on ``cfg``: 20 ms
    chunks, the causal contour search (f0_snap_halo 0, f0_snap_left 6),
    stage 1 of 3 blocks of kernel 3, SR of 1 block."""
    from realtime_yukarin_tpu_torch.config import (AcousticModelConfig,
                                                   StreamingConfig,
                                                   SuperResolutionConfig)
    return dataclasses.replace(
        cfg, streaming=StreamingConfig(chunk_ms=20.0),
        dsp=dataclasses.replace(cfg.dsp, f0_snap_halo=0, f0_snap_left=6),
        acoustic=AcousticModelConfig(num_blocks=3, kernel_size=3),
        super_resolution=SuperResolutionConfig(num_blocks=1))


def rate_config(cfg, rate: int | None):
    """``cfg`` with a ``rate`` Hz client in and out (None: unchanged)."""
    if rate is None:
        return cfg
    return dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=rate, output_rate=rate))


def stream_replay_vs_eager(params, cfg, mode: str, steps: int, dev) -> dict:
    """A VoiceChangerStream (its captured program on CUDA) against the
    ``streaming_step`` loop from the same init carry on the same chunks:
    ``torch.equal`` on each step's output and every carry leaf.  Returns
    {"mismatched": [step, ...], "program": the stream's program}."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        init_stream, noise_key_from_seed, streaming_step)
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

    stream = VoiceChangerStream(params, cfg, seed=SEED, vocoder_mode=mode,
                                device=dev)
    p = params_to(params, dev)
    with torch.no_grad():
        carry, _ = init_stream(p, cfg, vocoder_mode=mode, device=dev)
    key = torch.tensor(noise_key_from_seed(SEED), dtype=torch.int64,
                       device=dev)
    S, fs = stream.chunk_samples, cfg.dsp.in_rate
    x = test_signal(steps * S / fs + 0.01, fs, SEED)
    mismatched = []
    for k in range(steps):
        c = torch.from_numpy(x[k * S: (k + 1) * S]).to(dev)
        y = stream.step_device(c)
        with torch.no_grad():
            y_ref, carry = streaming_step(p, carry, c, key, cfg,
                                          vocoder_mode=mode)
        if not (torch.equal(y, y_ref) and leaves_equal(stream._carry,
                                                       carry)):
            mismatched.append(k)
    return {"mismatched": mismatched, "program": stream.program}


def batched_replay_vs_eager(params, cfg, N: int, steps: int, dev) -> dict:
    """A BatchedServer at N lanes (its captured program on CUDA) against
    ``make_batched_step``'s step from the same carries over phase 12's
    schedule (``lane_masks``), both fed device tensors: ``torch.equal`` on
    each step's output and every carry leaf; and an output held across
    the next step keeps its value.  Returns {"mismatched": [...],
    "held": bool, "program": the server's program}."""
    import torch
    from realtime_yukarin_tpu_torch.parallel.serving import (
        BatchedServer, make_batched_step)
    from realtime_yukarin_tpu_torch.streaming.state import tree_map

    server = BatchedServer(params, cfg, num_streams=N, seed=SEED,
                           device=dev)
    step = make_batched_step(cfg)
    init = server._init_carry
    carries = tree_map(lambda x: x.expand(N, *x.shape).clone(), init)
    S = server.chunk_samples
    x = lane_signals(N, LANE_STEPS, cfg.dsp.in_rate, S)     # phase 12's
    chunks = x[:, : steps * S].reshape(N, steps, S).transpose(1, 0, 2)
    mismatched, held = [], True
    for k in range(steps):
        live, reset = lane_masks(N, k)
        c, lv, rs = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (chunks[k], live, reset))
        y = server.step_device(c, lv, rs)
        if k:
            held = held and torch.equal(prev, prev_ref)
        with torch.no_grad():
            y_ref, carries = step(server._params, init, carries, c,
                                  server._keys, lv, rs)
        if not (torch.equal(y, y_ref) and leaves_equal(server._carries,
                                                       carries)):
            mismatched.append(k)
        prev, prev_ref = y, y_ref.clone()
    return {"mismatched": mismatched, "held": held,
            "program": server.program}


def offline_replay_vs_eager(params, cfg, x, dev) -> dict:
    """``offline_convert`` in each vocoder mode, called three times at one
    length (``x`` with seed SEED's noise, 0.5 x with SEED + 1's, x with
    SEED + 2's): the first call runs eagerly, the second captures the
    length's program and replays it, the third replays; each call against
    ``offline_convert_eager``.  Returns {mode: {"equal": bool, "program":
    the captured program}}."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.pipeline import (cached_programs,
                                                     offline_convert,
                                                     offline_convert_eager)
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        noise_key_from_seed)

    p = params_to(params, dev)
    F = len(x) // cfg.dsp.hop
    out = {}
    for mode in VOCODER_MODES:
        calls = [(x, noise_key_from_seed(SEED)),
                 (0.5 * x, noise_key_from_seed(SEED + 1)),
                 (x, noise_key_from_seed(SEED + 2))]
        ys = [offline_convert(p, w, key, cfg, F, vocoder_mode=mode,
                              device=dev) for w, key in calls]
        refs = [offline_convert_eager(p, w, key, cfg, F, vocoder_mode=mode,
                                      device=dev) for w, key in calls]
        out[mode] = {"equal": all(torch.equal(y, r)
                                  for y, r in zip(ys, refs)),
                     "program": cached_programs()[-1]}
    return out


def lists_replays(st: dict) -> bool:
    """Whether a ``profile_stats`` window of one replay per call lists the
    graph's kernels one by one: each of the port's forward kernels appears
    by name exactly once per call."""
    return all(st["port"][k][1] == 1 for k in FORWARD_KERNELS)


def wall_ms(fn, n: int) -> tuple[float, float]:
    """p50 / p99 host wall time of ``fn`` in ms over ``n`` calls (each
    ends in a device sync), after 3 warm-up calls."""
    for _ in range(3):
        fn()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return (float(np.percentile(walls, 50)) * 1e3,
            float(np.percentile(walls, 99)) * 1e3)


def captured_phase(cfg, dev="cuda") -> dict:
    """Phase 19: every captured program against its eager body, bit for
    bit, then eager and captured side by side.  (a) CAPTURE_STEPS steps of
    VoiceChangerStream in each of CAPTURE_STREAMS against the
    ``streaming_step`` loop; BatchedServer at BATCH_STREAMS lanes over
    phase 12's schedule against ``make_batched_step``'s step;
    ``offline_convert`` of SECONDS in each mode, three times (eager,
    capture, replay), against ``offline_convert_eager``.  (b) per program:
    warm-up plus capture time, pool bytes, GPU kernels per replay, each
    forward kernel's launches per replay: exactly 1 as captured, as listed
    by ``torch.profiler`` on the device, and as counted over CAPTURE_COUNT
    replays.  (c) bf16: the stream step's p50 / p99 per mode, the batched
    step at each of SERVE_STREAMS (p50 / p99, aggregate x realtime, device
    busy, idle share, host launch calls per step), offline (eager, the
    first call, which runs eagerly, the second with its capture, a
    replay); every replayed window's profile must list each forward
    kernel once per replay.  Returns {label: record} for the kernels
    line."""
    import torch
    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.serving import (
        BatchedServer, make_batched_step)
    from realtime_yukarin_tpu_torch.pipeline import (cached_programs,
                                                     offline_convert,
                                                     offline_convert_eager)
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        init_stream, noise_key_from_seed, streaming_step)
    from realtime_yukarin_tpu_torch.streaming.state import tree_map
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

    dev = torch.device(dev)
    params = vocoder_params(cfg)
    fails, programs = [], {}
    # (a) replay == eager, bit for bit
    for mode, dtype, rate in CAPTURE_STREAMS:
        c = rate_config(dataclasses.replace(cfg, compute_dtype=dtype), rate)
        label = f"stream {mode} {dtype}" + (f" {rate // 1000} kHz"
                                            if rate else "")
        r = stream_replay_vs_eager(params, c, mode, CAPTURE_STEPS, dev)
        programs[label] = r["program"]
        print(f"[captured] {label}: {CAPTURE_STEPS} replays vs the "
              f"streaming_step loop, bit-equal={not r['mismatched']}"
              + (f" (steps {r['mismatched']} differ)"
                 if r["mismatched"] else ""))
        if r["mismatched"]:
            fails.append(label)
    r = batched_replay_vs_eager(params, cfg, BATCH_STREAMS, BATCH_STEPS, dev)
    label = f"batched {BATCH_STREAMS} lanes"
    programs[label] = r["program"]
    print(f"[captured] {label} (lane {PAUSED_LANE} paused for steps "
          f"{PAUSE_STEPS}, lane {RESET_LANE} reset at step {RESET_STEP}): "
          f"{BATCH_STEPS} replays vs make_batched_step's step, bit-equal="
          f"{not r['mismatched']}, outputs held across the next step "
          f"unchanged={r['held']}")
    if r["mismatched"] or not r["held"]:
        fails.append(label)
    x = test_signal(SECONDS, cfg.dsp.sample_rate, SEED)
    for mode, r in offline_replay_vs_eager(params, cfg, x, dev).items():
        label = f"offline {mode}"
        programs[label] = r["program"]
        print(f"[captured] {label} ({len(x) // cfg.dsp.hop} frames): three "
              f"calls (eager, capture and replay, replay) vs "
              f"offline_convert_eager, bit-equal={r['equal']}")
        if not r["equal"]:
            fails.append(label)
    # (b) per program
    for label, prog in programs.items():
        fwd = {k: prog.kernel_launches.get(k, 0) for k in FORWARD_KERNELS}
        st = profile_stats(prog, PROFILE_STEPS)
        seen = {k: st["port"][k][1] for k in FORWARD_KERNELS}
        print(f"[captured] {label}: captured={prog.captured}, warm-up + "
              f"capture {prog.capture_s:.3f} s, pool "
              f"{prog.pool_bytes / 2 ** 20:.1f} MiB, GPU kernels and copies "
              f"per call (the replay and the output's clone) "
              f"{st['gpu_launches']:.1f}, forward kernels per replay: "
              f"captured {fwd}, on the device (torch.profiler) {seen}")
        cuda.reset_counts()
        for _ in range(CAPTURE_COUNT):
            prog()
        counted = {k: launch_counts()[k] for k in FORWARD_KERNELS}
        if (not prog.captured or set(fwd.values()) != {1}
                or not lists_replays(st)
                or set(counted.values()) != {CAPTURE_COUNT}):
            fails.append(f"{label}: launches {fwd}, on the device {seen}, "
                         f"{counted} over {CAPTURE_COUNT} replays")
    # (c) eager and captured side by side, bf16
    record = {}
    p = params_to(params, dev)
    for mode, _, rate in CAPTURE_STREAMS[:4]:
        c = rate_config(cfg, rate)
        label = f"stream {mode}" + (f" {rate // 1000} kHz" if rate else "")
        stream = VoiceChangerStream(params, c, seed=SEED, vocoder_mode=mode,
                                    device=dev)
        with torch.no_grad():
            state = {"carry": init_stream(p, c, vocoder_mode=mode,
                                          device=dev)[0]}
        key = torch.tensor(noise_key_from_seed(SEED), dtype=torch.int64,
                           device=dev)
        chunk = test_signal(0.1, c.dsp.in_rate, SEED)[
            : stream.chunk_samples]

        def eager(c=c, mode=mode, state=state, key=key, chunk=chunk):
            with torch.no_grad():
                y, state["carry"] = streaming_step(
                    p, state["carry"], torch.from_numpy(chunk).to(dev), key,
                    c, vocoder_mode=mode)
            return y.cpu()

        def replay(stream=stream, chunk=chunk):
            return stream.step_device(torch.from_numpy(chunk)).cpu()

        st = profile_stats(replay, PROFILE_STEPS)
        rep = st["gpu_launches"]
        if not lists_replays(st):
            fails.append(f"{label}: the profile of its replays shows "
                         f"{ {k: st['port'][k][1] for k in FORWARD_KERNELS} }"
                         f" forward kernels per replay")
        eag = profile_stats(eager, PROFILE_STEPS)["gpu_launches"]
        e50, e99 = wall_ms(eager, SERVE_STEPS)
        r50, r99 = wall_ms(replay, SERVE_STEPS)
        record[label] = dict(eager_p50_ms=e50, eager_p99_ms=e99,
                             captured_p50_ms=r50, captured_p99_ms=r99,
                             graph_kernels=rep, eager_gpu_launches=eag)
        print(f"[captured] {label} (bf16): step p50 / p99 eager {e50:.3f} / "
              f"{e99:.3f} ms, captured {r50:.3f} / {r99:.3f} ms; GPU kernels "
              f"and copies per replay {rep:.1f}, per eager step {eag:.1f} "
              f"(torch.profiler)")
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    step = make_batched_step(cfg)
    for N in SERVE_STREAMS:
        server = BatchedServer(params, cfg, num_streams=N, seed=SEED,
                               device=dev)
        S = server.chunk_samples
        xs = np.ascontiguousarray(lane_signals(
            BATCH_STREAMS, LANE_STEPS, cfg.dsp.in_rate, S)[:N, :S])
        carries = {"c": tree_map(lambda t: t.expand(N, *t.shape).clone(),
                                 server._init_carry)}
        ones = torch.ones(N, dtype=torch.bool, device=dev)
        zeros = torch.zeros(N, dtype=torch.bool, device=dev)

        def eager(server=server, xs=xs, carries=carries, ones=ones,
                  zeros=zeros):
            with torch.no_grad():
                y, carries["c"] = step(server._params, server._init_carry,
                                       carries["c"],
                                       torch.from_numpy(xs).to(dev),
                                       server._keys, ones, zeros)
            return y.cpu()

        def replay(server=server, xs=xs):
            return server.step(xs)

        rec = {}
        for how, fn in (("eager", eager), ("captured", replay)):
            p50, p99 = wall_ms(fn, SERVE_STEPS)
            st = profile_stats(fn, PROFILE_STEPS)
            busy = st["busy_ms"]
            if how == "captured" and not lists_replays(st):
                fails.append(f"batched N={N}: the profile of its replays "
                             f"shows {st['port']}")
            rec[how] = dict(p50_ms=p50, p99_ms=p99,
                            x_realtime=N * chunk_s * 1e3 / p50, busy_ms=busy,
                            idle=1.0 - busy / st["wall_ms"],
                            idle_at_p50=1.0 - busy / p50,
                            gpu_launches=st["gpu_launches"],
                            host_launches=st["host_launches"])
            print(f"[captured] batched N={N} {how} (bf16): step p50 / p99 "
                  f"{p50:.3f} / {p99:.3f} ms, aggregate "
                  f"x{rec[how]['x_realtime']:.1f} realtime, device busy "
                  f"{busy:.3f} ms (torch.profiler), idle share "
                  f"{rec[how]['idle']:.3f} in the profiled window "
                  f"({st['wall_ms']:.3f} ms per step), "
                  f"{rec[how]['idle_at_p50']:.3f} at the unprofiled p50, "
                  f"GPU kernels and copies per step "
                  f"{st['gpu_launches']:.1f}, host launch/copy calls per "
                  f"step {st['host_launches']:.1f}")
        record[f"batched {N}"] = rec
        del server
    F = len(x) // cfg.dsp.hop
    key = noise_key_from_seed(SEED)
    for mode in VOCODER_MODES:
        p_new = params_to(params, dev)       # new tensors: a new program

        def call(p_new=p_new, mode=mode):
            t0 = time.perf_counter()
            offline_convert(p_new, x, key, cfg, F, vocoder_mode=mode,
                            device=dev).cpu()
            return (time.perf_counter() - t0) * 1e3

        first, second = call(), call()
        capture = cached_programs()[-1].capture_s * 1e3
        eager_ms = wall_ms(lambda: offline_convert_eager(
            p_new, x, key, cfg, F, vocoder_mode=mode, device=dev).cpu(),
            5)[0]
        replay = wall_ms(call, 5)[0]
        record[f"offline {mode}"] = dict(eager_ms=eager_ms,
                                         first_call_ms=first,
                                         second_call_ms=second,
                                         capture_ms=capture,
                                         replay_ms=replay)
        print(f"[captured] offline {mode} {SECONDS:g} s (bf16): eager "
              f"{eager_ms:.3f} ms (p50 of 5), first call (eager) "
              f"{first:.1f} ms, second call {second:.1f} ms (warm-up and "
              f"capture {capture:.1f} ms of it), replay {replay:.3f} ms "
              f"(p50 of 5)")
    if fails:
        raise AssertionError(f"captured programs: {fails}")
    return record


# -- the captured training steps (phase 20) ----------------------------------

def training_runs(cfg, dev, params=None, disc=None) -> dict:
    """{objective: (make_state, eager body, make_step, batch view)} for the
    joint, GAN and fine-tune steps from ``params`` (default: phase 7's
    perturbed weights) and ``disc`` (default: the seeded discriminator).
    ``make_state`` gives a fresh state from the same weights each call;
    the body updates a state in place and returns the metrics, the step
    (``StepProgram``) does the same through its program; the view turns a
    training Batch into the objective's batch (the fine-tune's tuple of
    the self-vocoding rows)."""
    import copy
    import functools
    import torch
    from realtime_yukarin_tpu_torch.models.discriminator import (
        init_discriminator)
    from realtime_yukarin_tpu_torch.training import full_chain as fc
    from realtime_yukarin_tpu_torch.training import train_step as ts

    if params is None:
        params = perturbed_training_params(cfg)
    if disc is None:
        disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                                  torch.Generator().manual_seed(SEED + 1))

    def finetune_state():
        voc = {k: copy.deepcopy(params[k]).to(dev).train().requires_grad_(
            True) for k in fc.VOCODERS}
        return fc.FinetuneState(voc, fc.make_finetune_optimizer(
            fc.vocoder_leaves(voc), FINETUNE_LR))

    def voc_rows(b):
        return (b.f0_voc, b.env_voc, b.ap_voc, b.mc_voc, b.wave_voc, b.noise)

    return {
        "joint": (lambda: ts.init_train_state(params, dev),
                  functools.partial(ts.joint_step_body, cfg=cfg),
                  lambda: ts.make_train_step(cfg), lambda b: b),
        "gan": (lambda: ts.init_gan_train_state(params, disc, dev),
                functools.partial(ts.gan_step_body, cfg=cfg),
                lambda: ts.make_gan_train_step(cfg), lambda b: b),
        "finetune": (finetune_state,
                     functools.partial(fc.finetune_step_body, cfg=cfg),
                     lambda: fc.make_finetune_step(cfg), voc_rows)}


def states_equal(a, b) -> bool:
    """Whether two training states hold the same tensors bit for bit:
    every parameter, moment, step count, EMA and discriminator leaf."""
    import torch
    from realtime_yukarin_tpu_torch.training.train_step import state_leaves
    la, lb = state_leaves(a), state_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def metrics_equal(a: dict, b: dict) -> bool:
    import torch
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def eager_twice(run, batches) -> bool:
    """Two eager runs of the body from one snapshot of the state over
    ``batches``: bit-equal states and metrics after every step."""
    make_state, body, _, view = run
    a, b = make_state(), make_state()
    return all(metrics_equal(body(a, view(x)), body(b, view(x)))
               and states_equal(a, b) for x in batches)


def train_replay_vs_eager(run, batches) -> dict:
    """The step (its program: captured on CUDA) against the eager body
    from the same state on ``batches``: ``torch.equal`` on the metrics and
    every state leaf after each step.  Returns {"mismatched": [step, ...],
    "step": the step, "state": its state, "batch": the last batch's
    view}."""
    make_state, body, make_step, view = run
    eager, state = make_state(), make_state()
    step = make_step()
    mismatched = []
    for k, x in enumerate(batches):
        _, m = step(state, view(x))
        if not (metrics_equal(body(eager, view(x)), m)
                and states_equal(eager, state)):
            mismatched.append(k)
    return {"mismatched": mismatched, "step": step, "state": state,
            "batch": view(batches[-1])}


def analysis_replay_vs_eager(cfg, waves, F: int, dev) -> dict:
    """``offline_analyze`` at F frames on each of ``waves`` (the first call
    at a new length runs eagerly, the second captures) against
    ``offline_analyze_eager``.  Returns {"equal": bool, "program": the
    length's program}."""
    import torch
    from realtime_yukarin_tpu_torch.pipeline import (cached_programs,
                                                     offline_analyze,
                                                     offline_analyze_eager)
    equal = True
    for w in waves:
        a = offline_analyze(w, cfg, F, dev)
        b = offline_analyze_eager(w, cfg, F, dev)
        equal &= all(torch.equal(getattr(a, k), getattr(b, k))
                     for k in ("f0", "env", "ap", "mc"))
    name = f"analysis {F} frames"
    return {"equal": equal, "program": [p for p in cached_programs()
                                        if p.name == name][-1]}


def synthesis_replay_vs_eager(cfg, feats, dev) -> dict:
    """``offline_synthesize`` on each of ``feats`` (one length, each with
    its own noise key) against ``offline_synthesize_eager``.  Returns
    {"equal": bool, "program": the length's program}."""
    import torch
    from realtime_yukarin_tpu_torch.pipeline import (
        cached_programs, offline_synthesize, offline_synthesize_eager)
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        noise_key_from_seed)
    equal = True
    for i, f in enumerate(feats):
        key = noise_key_from_seed(SEED + i)
        equal &= torch.equal(offline_synthesize(f, key, cfg),
                             offline_synthesize_eager(f, key, cfg))
    name = f"synthesis {feats[0].f0.shape[0]} frames"
    return {"equal": equal, "program": [p for p in cached_programs()
                                        if p.name == name][-1]}


def captured_training_phase(cfg, dev="cuda", quality_s=None) -> dict:
    """Phase 20: the training steps and the analysis and synthesis
    programs against their eager bodies, then eager and captured side by
    side.  (a) two eager runs of DET_STEPS steps from one state,
    bit-equal, per objective; (b) TRAIN_REPLAYS replays against the eager
    body per objective; the analysis program at TRAIN_FRAMES and at a
    prepared file's bucket length, and ``offline_synthesize``, against
    their eager bodies; (c) each program's port kernels per replay, as
    captured, as counted and as ``torch.profiler`` lists them on the
    device, against the eager step's counts; (d) the steps' p50 / p99
    eager and captured, device busy and idle share, host launch calls,
    capture time and pool; ``make_batch`` as its host synthesis and its
    analysis eagerly and through the program; phase 17 (a)'s preparation
    of CORPUS_PAIRS pairs with eager analysis and with the programs; the
    quality recipe's wall time (``quality_s``, phase 17 (c)).  Returns
    {label: record}, with the launches of (a) and (b) under "launches"."""
    import pathlib
    import tempfile
    import torch
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.pipeline import offline_analyze_eager
    from realtime_yukarin_tpu_torch.training import corpus, data
    from realtime_yukarin_tpu_torch.utils.audio_io import read_wav

    dev = torch.device(dev)
    seconds = TRAIN_FRAMES * cfg.dsp.hop / cfg.dsp.sample_rate
    hosts = [data.synth_batch(cfg, TRAIN_BATCH, seconds, seed=SEED + 40 + i)
             for i in range(TRAIN_REPLAYS)]
    batches = [data.analyze_batch(cfg, *h, device=dev) for h in hosts]
    runs = training_runs(cfg, dev)
    fails, programs, record = [], {}, {}
    cuda.reset_counts()
    # (a) determinism, (b) replay == eager
    for name, run in runs.items():
        same = eager_twice(run, batches[:DET_STEPS])
        r = train_replay_vs_eager(run, batches)
        programs[name] = (r["step"].program, run, r)
        print(f"[captured-train] {name}: two eager runs of {DET_STEPS} steps "
              f"from one state bit-equal={same}; {TRAIN_REPLAYS} replays vs "
              f"the eager body bit-equal={not r['mismatched']}"
              + (f" (steps {r['mismatched']} differ)" if r["mismatched"]
                 else ""))
        if not same or r["mismatched"]:
            fails.append(f"{name}: eager twice equal {same}, replays "
                         f"{r['mismatched']} differ")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        src, tgt, audio_s = _wav_pairs(root, CORPUS_PAIRS,
                                       cfg.dsp.sample_rate)
        bucket = corpus.frame_bucket(int(CORPUS_SECONDS[1]
                                         * cfg.dsp.sample_rate)
                                     // cfg.dsp.hop, CORPUS_BUCKET)
        file_waves = [torch.from_numpy(np.pad(
            read_wav(str(p), target_rate=cfg.dsp.sample_rate)[0],
            (0, bucket * cfg.dsp.hop))[: bucket * cfg.dsp.hop])
            for p in sorted(tgt.glob("*.wav"))[:4]]
        analyses = {
            TRAIN_FRAMES: analysis_replay_vs_eager(
                cfg, [torch.from_numpy(w) for w in hosts[0][0]],
                TRAIN_FRAMES, dev),
            bucket: analysis_replay_vs_eager(cfg, file_waves, bucket, dev)}
        for F, r in analyses.items():
            print(f"[captured-train] analysis at {F} frames: "
                  f"{len(file_waves) if F == bucket else TRAIN_BATCH} calls "
                  f"vs offline_analyze_eager bit-equal={r['equal']}")
            programs[f"analysis {F}"] = (r["program"], None, None)
            if not r["equal"]:
                fails.append(f"analysis {F}")
        feats = [offline_analyze_eager(w, cfg, bucket, dev)
                 for w in file_waves[:3]]
        r = synthesis_replay_vs_eager(cfg, feats, dev)
        print(f"[captured-train] offline_synthesize at {bucket} frames: 3 "
              f"calls vs offline_synthesize_eager bit-equal={r['equal']}")
        programs[f"synthesis {bucket}"] = (r["program"], None, None)
        if not r["equal"]:
            fails.append("synthesis")
        record["launches"] = launch_counts()
        # (c) kernels per replay: captured, counted, listed; the eager
        # step's counts
        for label, (prog, run, rr) in programs.items():
            captured = {k: prog.kernel_launches.get(k, 0)
                        for k in launch_counts()}
            if run is not None:
                make_state, body, _, view = run
                st_e = make_state()
                cuda.reset_counts()
                body(st_e, rr["batch"])
                eager = launch_counts()
                step, state = rr["step"], rr["state"]

                def call(step=step, state=state, b=rr["batch"]):
                    step(state, b)
                    torch.cuda.synchronize()
            else:
                eager = dict(captured)

                def call(prog=prog):
                    prog()
                    torch.cuda.synchronize()
            want = {k: float(n) for k, n in captured.items()}
            for _ in range(3):      # the profiler drops events now and then
                st = profile_stats(call, PROFILE_STEPS)
                listed = {k: st["port"][k][1] for k in captured}
                if listed == want:
                    break
            cuda.reset_counts()
            for _ in range(CAPTURE_COUNT):
                call()
            counted = launch_counts()
            ok = (prog.captured and captured == eager
                  and listed == want and counted == {k: CAPTURE_COUNT * n
                                  for k, n in captured.items()})
            print(f"[captured-train] {label}: captured={prog.captured}, "
                  f"warm-up + capture {prog.capture_s:.3f} s, pool "
                  f"{prog.pool_bytes / 2 ** 20:.1f} MiB; port kernels per "
                  f"replay: captured {captured}, eager step {eager}, listed "
                  f"by torch.profiler {listed}, counted over "
                  f"{CAPTURE_COUNT} replays {counted}")
            if not ok:
                fails.append(f"{label}: kernels per replay captured "
                             f"{captured}, eager {eager}, listed {listed}, "
                             f"counted {counted}")
        # (d) times, eager and captured side by side
        for name in TRAIN_OBJECTIVES:
            prog, run, rr = programs[name]
            make_state, body, _, view = run
            eager_state, b = make_state(), rr["batch"]
            step, state = rr["step"], rr["state"]

            def eager(st=eager_state, b=b, body=body):
                body(st, b)
                torch.cuda.synchronize()

            def replay(step=step, st=state, b=b):
                step(st, b)
                torch.cuda.synchronize()

            rec = {}
            for how, fn in (("eager", eager), ("captured", replay)):
                p50, p99 = wall_ms(fn, TRAIN_TIMED)
                st = profile_stats(fn, PROFILE_STEPS)
                rec[how] = dict(p50_ms=p50, p99_ms=p99, busy_ms=st["busy_ms"],
                                idle=st["idle"],
                                idle_at_p50=1.0 - st["busy_ms"] / p50,
                                gpu_launches=st["gpu_launches"],
                                host_launches=st["host_launches"])
                print(f"[captured-train] {name} step {how} (float32, "
                      f"{TRAIN_BATCH} x {TRAIN_FRAMES} frames): p50 / p99 "
                      f"{p50:.3f} / {p99:.3f} ms, device busy "
                      f"{st['busy_ms']:.3f} ms (torch.profiler), idle share "
                      f"{st['idle']:.3f} in the profiled window, "
                      f"{rec[how]['idle_at_p50']:.3f} at the unprofiled p50, "
                      f"GPU kernels and copies per step "
                      f"{st['gpu_launches']:.1f}, host launch/copy calls per "
                      f"step {st['host_launches']:.1f}")
            rec.update(capture_s=prog.capture_s, pool_mib=prog.pool_bytes
                       / 2 ** 20)
            record[name] = rec
        waves = [torch.from_numpy(w) for w in hosts[0][0] + hosts[0][1]]

        def analysis_eager():
            for w in waves:
                offline_analyze_eager(w, cfg, TRAIN_FRAMES, dev)
            torch.cuda.synchronize()

        def analysis_captured():
            data.analyze_batch(cfg, *hosts[0], device=dev)
            torch.cuda.synchronize()

        parts = {"synthesis (host)": lambda: data.synth_batch(
                     cfg, TRAIN_BATCH, seconds, seed=SEED + 40),
                 "analysis eager": analysis_eager,
                 "analysis captured": analysis_captured}
        rec = {}
        for part, fn in parts.items():
            rec[part] = wall_ms(fn, 8)
            print(f"[captured-train] make_batch {part}: p50 / p99 "
                  f"{rec[part][0]:.3f} / {rec[part][1]:.3f} ms "
                  f"({TRAIN_BATCH} pairs of {TRAIN_FRAMES} frames)")
        record["make_batch"] = rec
        # phase 17 (a)'s preparation, its analysis eager, then the programs
        prep = {}
        programmed = corpus.offline_analyze
        for how, analyze in (("eager", offline_analyze_eager),
                             ("captured", programmed)):
            corpus.offline_analyze = analyze
            try:
                t0 = time.perf_counter()
                corpus.prepare_corpus(str(src), str(tgt),
                                      str(pathlib.Path(root) / how), cfg,
                                      bucket_frames=CORPUS_BUCKET,
                                      verbose=False, device=dev)
                sync(dev)
                prep[how] = time.perf_counter() - t0
            finally:
                corpus.offline_analyze = programmed
        print(f"[captured-train] preparation of {CORPUS_PAIRS} pairs "
              f"({audio_s:.1f} s of audio): analysis eager {prep['eager']:.3f}"
              f" s, through the programs {prep['captured']:.3f} s")
        record["prepare_s"] = prep
    if quality_s is not None:
        print(f"[captured-train] the quality recipe (phase 17 (c), captured "
              f"steps and programs): {quality_s:.1f} s")
        record["quality_s"] = quality_s
    if fails:
        raise AssertionError(f"captured training: {fails}")
    return record


# -- the step's cost (phase 21) ----------------------------------------------

def count_step_both(params, cfg, N: int, mode: str, label: str,
                    fails: list):
    """One batched step at N lanes counted on the card and on the CPU, at
    the same Config and weights (``BatchedServer.count_step``,
    ``model_stage_flops``): the FLOPs and the learned stages' FLOPs must
    be equal exactly; the bytes are printed with the ops where they part;
    the card's kernel launches and their R must be those of one replay of
    the captured program (``Capture.launches``).  Returns (the card's
    server, its count, its stage counts)."""
    from realtime_yukarin_tpu_torch.parallel.serving import (
        BatchedServer, model_stage_flops)
    servers = [BatchedServer(params, cfg, num_streams=N, seed=SEED,
                             vocoder_mode=mode, device=d)
               for d in ("cuda", "cpu")]
    (c_dev, c_cpu), (m_dev, m_cpu) = ([s.count_step() for s in servers],
                                      [model_stage_flops(s)
                                       for s in servers])
    srv = servers[0]
    replay = sorted((k.computes, launch_shape(k.computes, a))
                    for k, a in srv.program._capture.launches)
    counted = sorted((k.name, k.shape) for k in c_dev.kernels)
    parted = {op: (c_dev.op_bytes[op], c_cpu.op_bytes[op])
              for op in set(c_dev.op_bytes) | set(c_cpu.op_bytes)
              if c_dev.op_bytes[op] != c_cpu.op_bytes[op]}
    print(f"[cost] {label}: FLOPs card {c_dev.flops} / CPU {c_cpu.flops} "
          f"(equal={c_dev.flops == c_cpu.flops}), bytes card {c_dev.bytes} "
          f"/ CPU {c_cpu.bytes}"
          + (f" (parting ops: {parted})" if parted else " (equal)")
          + f"; learned stages card {m_dev} / CPU {m_cpu}; kernel launches "
          f"counted {counted}, one replay's record {replay} "
          f"(equal={counted == replay})")
    if c_dev.flops != c_cpu.flops or m_dev != m_cpu:
        fails.append(f"{label}: card and CPU counts differ")
    if not srv.captured or counted != replay:
        fails.append(f"{label}: counted kernels {counted}, captured {replay}")
    return srv, c_dev, m_dev


def print_cost(label: str, count, stages: dict, N: int, chunk_s: float,
               p50_ms: float | None = None) -> dict:
    """Print a count's FLOPs, bytes, learned and structural FLOPs, the
    kernels' share, and with the captured step's p50 the achieved rate;
    returns them as a record."""
    model = sum(stages.values())
    kern = sum(k.flops for k in count.kernels)
    rec = dict(flops=count.flops, bytes=count.bytes, model_flops=model,
               structural_flops=count.flops - model, kernel_flops=kern,
               model_flops_per_audio_s=model / (N * chunk_s))
    line = (f"[cost] {label}: {count.flops} FLOPs "
            f"({count.flops / N / 1e9:.4f} GFLOP per stream), "
            f"{count.bytes} bytes (unfused), learned stages {model} "
            f"({model / count.flops:.4f} of the FLOPs: {stages}), "
            f"structural {count.flops - model}, the port's kernels {kern} "
            f"({kern / count.flops:.4f}); learned-stage FLOPs per audio "
            f"second {rec['model_flops_per_audio_s']:.4e}")
    if p50_ms is not None:
        tflops = count.flops / (p50_ms * 1e-3) / 1e12
        rec.update(p50_ms=p50_ms, achieved_tflops=tflops)
        line += (f"; captured step p50 {p50_ms:.3f} ms -> {tflops:.3f} "
                 f"TFLOP/s achieved, {tflops * 1e12 / PEAK_BF16_FLOPS:.5f} "
                 f"of the bf16 dense peak and "
                 f"{tflops * 1e12 / PEAK_F32_FLOPS:.5f} of the float32 peak "
                 f"(not an MFU: the count includes structural matmuls, the "
                 f"DFT bases, one-hots and prefix sums, and the float32 "
                 f"DSP)")
    print(line)
    return rec


def cost_phase(cfg, checked: dict[str, set]) -> tuple[dict, dict]:
    """Phase 21: the step's cost.  (a) the default profile (dsp, bf16)
    counted at each of COST_STREAMS on the card and on the CPU
    (``count_step_both``); (b) the counted kernels against one replay's
    launch record; (c) after a count, a replay bit-equal to a second
    server's that never counted; (d) FLOPs, bytes, the learned and the
    structural FLOPs, the kernels' share and, with the captured step's p50
    (host chunks in and out), the achieved rate; a count refused inside a
    capture.  (e) the 20 ms profile on the card: one captured stream
    against its eager loop bit for bit and CUDA vs CPU in float32 (2e-3
    of the peak, identical voicing), a captured server at LL_STREAMS
    lanes against its eager step and timed, every kernel shape one phase
    3 held, then its step counted.  ddsp and wave counted at
    COST_MODE_STREAMS.  Returns ({label: record}, the 20 ms runs' kernel
    launches)."""
    import torch
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer

    dev = torch.device("cuda")
    params = vocoder_params(cfg)
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    fails, record = [], {}
    for N in COST_STREAMS:
        label = f"dsp bf16 N={N}"
        srv, count, stages = count_step_both(params, cfg, N, "dsp", label,
                                             fails)
        twin = BatchedServer(params, cfg, num_streams=N, seed=SEED,
                             device=dev)
        S = srv.chunk_samples
        x = lane_signals(N, 4, cfg.dsp.in_rate, S).reshape(
            N, 4, S).transpose(1, 0, 2).copy()
        for k in range(2):
            srv.step(x[k])
            twin.step(x[k])
        srv.step_cost_analysis()
        same = (np.array_equal(srv.step(x[2]), twin.step(x[2]))
                and leaves_equal(srv._carries, twin._carries))
        print(f"[cost] {label}: after a count, the next replay bit-equal to "
              f"a server's that never counted={same}")
        if not same:
            fails.append(f"{label}: a count changed the next replay")
        p50, _ = wall_ms(lambda srv=srv, x=x: srv.step(x[3]), SERVE_STEPS)
        record[label] = print_cost(label, count, stages, N, chunk_s, p50)
        del srv, twin
    # a count refuses to open inside a capture, on the card
    server = BatchedServer(params, cfg, num_streams=1, device=dev)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    one = torch.zeros(1, device=dev)
    refused = False
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        one.add_(1.0)
        try:
            server.step_cost_analysis()
        except RuntimeError:
            refused = True
    print(f"[cost] step_cost_analysis inside a CUDA graph capture raised="
          f"{refused}")
    if not refused:
        fails.append("a count opened inside a capture")
    for mode in ("ddsp", "wave"):
        label = f"{mode} bf16 N={COST_MODE_STREAMS}"
        _, count, stages = count_step_both(params, cfg, COST_MODE_STREAMS,
                                           mode, label, fails)
        record[label] = print_cost(label, count, stages, COST_MODE_STREAMS,
                                   chunk_s)
    # (e) the 20 ms profile
    ll = low_latency_config(cfg)
    ll_params = vocoder_params(ll)
    ll_chunk_s = ll.streaming.chunk_samples(ll.dsp) / ll.dsp.sample_rate
    shapes, undo = record_shapes()
    cuda.reset_counts()
    try:
        r = stream_replay_vs_eager(ll_params, ll, "dsp", CAPTURE_STEPS, dev)
        print(f"[cost] 20 ms profile, one stream: {CAPTURE_STEPS} replays "
              f"vs the streaming_step loop, bit-equal="
              f"{not r['mismatched']}; {r['program'].summary()}")
        if r["mismatched"] or not r["program"].captured:
            fails.append(f"20 ms stream: steps {r['mismatched']} differ")
        ll32 = dataclasses.replace(ll, compute_dtype="float32")
        x = test_signal(SECONDS, ll.dsp.sample_rate, SEED)
        yc, _, vc, _ = run_stream(ll_params, ll32, x, "cuda")
        yh, _, vh, _ = run_stream(ll_params, ll32, x, "cpu")
        perr = rel_peak(yc, yh)
        same_voicing = bool((vc == vh).all())
        print(f"[cost] 20 ms profile, one stream (float32): cuda vs cpu "
              f"max_err/peak={perr:.3e} (tol 2e-3), voicing identical="
              f"{same_voicing} ({int(vh.sum())} voiced of {vh.size} frames)")
        if perr > 2e-3 or not same_voicing:
            fails.append(f"20 ms stream: CUDA vs CPU {perr:.3e}, voicing "
                         f"identical={same_voicing}")
        b = batched_replay_vs_eager(ll_params, ll, LL_STREAMS, BATCH_STEPS,
                                    dev)
        print(f"[cost] 20 ms profile, {LL_STREAMS} lanes: {BATCH_STEPS} "
              f"replays vs make_batched_step's step, bit-equal="
              f"{not b['mismatched']}, outputs held={b['held']}; "
              f"{b['program'].summary()}")
        if b["mismatched"] or not b["held"] or not b["program"].captured:
            fails.append(f"20 ms batched: steps {b['mismatched']} differ")
        srv = BatchedServer(ll_params, ll, num_streams=LL_STREAMS, seed=SEED,
                            device=dev)
        S = srv.chunk_samples
        xs = np.ascontiguousarray(lane_signals(LL_STREAMS, 1,
                                               ll.dsp.in_rate, S))
        p50, p99 = wall_ms(lambda: srv.step(xs), SERVE_STEPS)
        st = profile_stats(lambda: srv.step(xs), PROFILE_STEPS)
        print(f"[cost] 20 ms profile, {LL_STREAMS} lanes captured (bf16): "
              f"step p50 / p99 {p50:.3f} / {p99:.3f} ms, aggregate "
              f"x{LL_STREAMS * ll_chunk_s * 1e3 / p50:.1f} realtime, device "
              f"busy {st['busy_ms']:.3f} ms (torch.profiler), idle share "
              f"{1.0 - st['busy_ms'] / p50:.3f} at the unprofiled p50, GPU "
              f"kernels and copies per step {st['gpu_launches']:.1f}")
    finally:
        undo()
    launches = launch_counts()
    unchecked = {k: sorted(set(v) - checked[k]) for k, v in shapes.items()
                 if set(v) - checked[k]}
    print(f"[cost] 20 ms profile: kernel launches {launches}, shapes "
          f"{ {k: sorted(set(v)) for k, v in shapes.items() if v} }")
    if unchecked:
        fails.append(f"20 ms profile: shapes phase 3 did not check: "
                     f"{unchecked}")
    label = f"20 ms dsp bf16 N={LL_STREAMS}"
    _, count, stages = count_step_both(ll_params, ll, LL_STREAMS, "dsp",
                                       label, fails)
    record[label] = print_cost(label, count, stages, LL_STREAMS, ll_chunk_s,
                               p50)
    ratio = (record[f"dsp bf16 N={COST_STREAMS[-1]}"]
             ["model_flops_per_audio_s"]
             / record[label]["model_flops_per_audio_s"])
    print(f"[cost] learned-stage FLOPs per audio second, the default "
          f"profile over the 20 ms profile: {ratio:.3f}")
    if fails:
        raise AssertionError(f"phase 21: {fails}")
    return record, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import realtime_yukarin_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the realtime_yukarin_tpu_torch package is "
              "missing; run from the repository root", file=sys.stderr)
        return 2
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.ops import cuda
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb

    # 1. device
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {device_name} x{count} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi)
    print(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    reports = cuda.build()
    print(f"[build] {len(reports)} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for kname, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}")

    # 3. kernels against their plain versions
    cfg = Config()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(lambda: one.add_(1.0))
    print(f"[kernel] launch floor: {floor_ms * 1e3:.2f} us device time per "
          f"launch (in-place add on a one-element tensor)")
    record = {}
    offline_rec = {}
    # the shapes held against the plain versions (launch_shape's)
    checked = {k.computes: set() for k in cuda.KERNELS}
    n_fft, H_d, hop_d = cfg.dsp.fft_size, cfg.dsp.num_harmonics, cfg.dsp.hop
    K_d = n_fft // 2 + 1
    for R in KERNEL_ROWS:
        for kname, case in kernel_cases(R, cfg, dev, rng).items():
            rec = kernel_phase(kname, R, n_fft, case)
            checked[kname].add((R, H_d, hop_d) if kname == "harmonic_bank"
                               else (R, K_d))
            if R == 20:
                record[kname] = rec
            if R == OFFLINE_FRAMES:
                offline_rec[kname] = rec
    analysis_rows, bank_rows = path_rows(cfg)
    for n, R in RAGGED_CASES + tuple((n_fft, R) for R in analysis_rows):
        cases = kernel_cases(R, cfg, dev, rng, n=n)
        for kname in ANALYSIS_KERNELS:
            kernel_phase(kname, R, n, cases[kname], timed=False)
            checked[kname].add((R, n // 2 + 1))
    for R, H, hop in BANK_RAGGED_CASES + tuple((R, H_d, hop_d)
                                              for R in bank_rows):
        e_fwd, e_bwd = bank_ragged(R, H, hop, dev, rng)
        torch.cuda.synchronize()
        ok = (e_fwd <= TOL["harmonic_bank"]
              and e_bwd <= TOL["harmonic_bank_bwd"])
        print(f"[kernel] bank R={R} H={H} hop={hop}: /peak forward "
              f"{e_fwd:.3e}, backward {e_bwd:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"bank at R={R} H={H} hop={hop}: errors "
                                 f"{e_fwd:.3e}, {e_bwd:.3e}")
        checked["harmonic_bank"].add((R, H, hop))
        checked["harmonic_bank_bwd"].add((R, H, hop, True))
    print(f"[kernel] the paths' other rows (path_rows), checked: analysis "
          f"{analysis_rows}, bank {bank_rows}")
    for R in SERVE_CELL_ROWS:
        cases = kernel_cases(R, cfg, dev, rng)
        for kname in ANALYSIS_KERNELS:
            kernel_phase(kname, R, n_fft, cases[kname])
            checked[kname].add((R, K_d))
    designs_phase(cfg, dev, rng)
    record["hifigan_tail"], tail_shapes = tail_phase(Config.from_dict(
        {"vocoder_mode": "hifigan"}), dev)
    checked["hifigan_tail"] |= tail_shapes
    record["bigvgan_act"], act_shapes, tail_shapes = bigvgan_act_phase(
        Config.from_dict({"vocoder_mode": "bigvgan"}), dev)
    checked["bigvgan_act"] |= act_shapes
    checked["hifigan_tail"] |= tail_shapes
    kname = "harmonic_bank_bwd"
    names = ("d_aL", "d_aR", "d_phi", "d_frac")
    for R in (TRAIN_FRAMES, QUALITY_ROWS, TRAIN_BATCH * TRAIN_FRAMES,
              MH_TRAIN_ROWS):
        kern, plain, nbytes, nflops, plain64, amps_only = bwd_case(
            R, cfg, dev, rng)
        outs, refs, ref64 = kern(), plain(), plain64()
        errs = [abs_rel_err(k, p) for k, p in zip(outs, refs)]
        e_k64 = [abs_rel_err(k.double(), x)[1] for k, x in zip(outs, ref64)]
        e_p64 = [abs_rel_err(p.double(), x)[1] for p, x in zip(refs, ref64)]
        torch.cuda.synchronize()
        err_abs = max(e[0] for e in errs)
        err = max(e[1] for e in errs)
        ok = err <= TOL[kname]
        ms, plain_ms = time_ms(kern), time_ms(plain)
        dev_ms, plain_dev = device_ms(kern), device_ms(plain)
        b_ms, b_by = bound_ms(nbytes, nflops)
        # the first design's count, 15 FLOP, for comparison with its bound
        first_ms, _ = bound_ms(nbytes, nflops * 15.0 / 14.0)
        print(f"[kernel] {kname} R={R}: /peak "
              + " ".join(f"{nm} {e[1]:.3e}" for nm, e in zip(names, errs))
              + f" (tol {TOL[kname]:g}) {'ok' if ok else 'FAIL'} | vs "
              f"float64 /peak kernel / plain: "
              + ", ".join(f"{nm} {a:.3e} / {b:.3e}"
                          for nm, a, b in zip(names, e_k64, e_p64))
              + f" | kernel {ms:.5f} ms (device {dev_ms:.5f} ms, wrapper "
              f"host {host_us(kern):.1f} us/call), plain {plain_ms:.5f} ms "
              f"(device {plain_dev:.5f} ms), library n/a, bound {b_ms:.5f} "
              f"ms ({b_by}, 14 FLOP; {first_ms:.5f} ms at the first "
              f"design's count of 15)")
        if not ok:
            raise AssertionError(f"{kname} R={R}: error {err:.3e} above "
                                 f"{TOL[kname]:g}")
        checked[kname].add((R, H_d, hop_d, True))
        # the launch a training step makes: d_aL and d_aR only (autograd
        # asks for no phase or frac gradient), held against the same plain
        # outputs and bound by its own operations and bytes
        a_outs = amps_only()[:2]
        a_errs = [abs_rel_err(k, p)[1] for k, p in zip(a_outs, refs)]
        a_k64 = [abs_rel_err(k.double(), x)[1]
                 for k, x in zip(a_outs, ref64)]
        torch.cuda.synchronize()
        a_ok = max(a_errs) <= TOL[kname]
        amps_ms = device_ms(amps_only)
        a_flops, a_bytes = hb.bank_backward_cost(R, H_d, hop_d, phase=False)
        a_ms, a_by = bound_ms(a_bytes, a_flops)
        print(f"[kernel] {kname} R={R} d_aL and d_aR only (the training "
              f"step's launch): /peak "
              + " ".join(f"{nm} {e:.3e}" for nm, e in zip(names, a_errs))
              + f" (tol {TOL[kname]:g}) {'ok' if a_ok else 'FAIL'} | vs "
              f"float64 /peak kernel / plain: "
              + ", ".join(f"{nm} {a:.3e} / {b:.3e}"
                          for nm, a, b in zip(names, a_k64, e_p64))
              + f" | device {amps_ms:.5f} ms, host "
              f"{host_us(amps_only):.1f} us/call, bound {a_ms:.5f} ms "
              f"({a_by})")
        if not a_ok:
            raise AssertionError(f"{kname} R={R} d_aL and d_aR only: error "
                                 f"{max(a_errs):.3e} above {TOL[kname]:g}")
        checked[kname].add((R, H_d, hop_d, False))
        if R != TRAIN_BATCH * TRAIN_FRAMES:
            continue
        # the kernels line's numbers: the training batch's width
        record[kname] = dict(max_abs_err=err_abs, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             device_ms=dev_ms, plain_device_ms=plain_dev,
                             library_device_ms=None,
                             amplitudes_only_device_ms=amps_ms)

    # 4. the main path at full width, bf16 models
    params = seeded_params(cfg)
    x = test_signal(SECONDS, cfg.dsp.sample_rate, SEED)
    cuda.reset_counts()
    y, secs, _, steps = run_stream(params, cfg, x, "cuda")
    launches = launch_counts()
    stream_kernels = (cuda.HARMONIC_BANK, cuda.POWER_SPECTRUM,
                      cuda.ENVELOPE_CEPSTRUM)
    rms = float(np.sqrt(np.mean(y ** 2)))
    chunk_s = cfg.streaming.chunk_samples(cfg.dsp) / cfg.dsp.sample_rate
    p50, p99 = (float(np.percentile(secs[1:], q)) for q in (50, 99))
    print(f"[main] {steps} steps, out {y.shape[0]} samples (in "
          f"{x.shape[0]}), finite={bool(np.isfinite(y).all())}, rms "
          f"{rms:.4f}, launches {launches}")
    print(f"[main] chunk wall time p50 {p50 * 1e3:.3f} ms p99 "
          f"{p99 * 1e3:.3f} ms (first chunk {secs[0] * 1e3:.1f} ms), "
          f"x{chunk_s / p50:.1f} realtime for one stream at p50")
    if y.shape[0] != x.shape[0] or not np.isfinite(y).all() or rms < 1e-3:
        raise AssertionError("main path output is wrong-sized, "
                             "non-finite or silent")
    for k in stream_kernels:
        if launches[k.name] < steps:
            raise AssertionError(f"{k.name} launched {launches[k.name]} "
                                 f"times in {steps} steps")

    # 5. parity: CUDA kernels vs the CPU plain versions, float32 models
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    yc, _, vc, _ = run_stream(params, cfg32, x, "cuda")
    yh, _, vh, _ = run_stream(params, cfg32, x, "cpu")
    perr = float(np.abs(yc - yh).max() / (np.abs(yh).max() + 1e-9))
    same_voicing = bool((vc == vh).all())
    print(f"[parity] cuda vs cpu: max_err/peak={perr:.3e} (tol 2e-3), "
          f"voicing identical={same_voicing} "
          f"({int(vh.sum())} voiced of {vh.size} frames)")
    if perr > 2e-3 or not same_voicing:
        raise AssertionError("CUDA and CPU outputs disagree")

    # 6. training at full width, float32
    cuda.reset_counts()
    trained = train_phase(cfg, dev)
    train_launches = launch_counts()
    n_train = trained["steps"]
    for objective, walls in trained["walls"].items():
        tail = walls[1:]
        print(f"[train] {objective}: step wall time (after the first) mean "
              f"{np.mean([w[1] for w in tail]) * 1e3:.1f} ms, make_batch "
              f"{np.mean([w[0] for w in tail]) * 1e3:.1f} ms (first step "
              f"{walls[0][1] * 1e3:.1f} ms)")
    print(f"[train] {n_train} steps, launches {train_launches}")
    if train_launches["harmonic_bank_bwd"] < n_train:
        raise AssertionError(f"harmonic_bank_bwd launched "
                             f"{train_launches['harmonic_bank_bwd']} times "
                             f"in {n_train} training steps")
    missing = [k for k in TPU_KERNELS if train_launches[k] == 0]
    if missing:
        raise AssertionError(f"the training path launched no {missing}")

    # 7. training parity: CUDA vs CPU
    train_parity(cfg, dev)

    # 8. offline on the card; the forward kernels' numbers at its width
    # (phase 3)
    t0 = time.perf_counter()
    voc_params = vocoder_params(cfg)
    offline_launches = offline_phase(cfg, voc_params, x, dev)
    F = len(x) // cfg.dsp.hop
    for kname, rec in offline_rec.items():
        print(f"[offline] {kname} at R={F} (phase 3): device "
              f"{rec['device_ms'] * 1e3:.2f} us per launch, plain "
              f"{rec['plain_device_ms'] * 1e3:.2f} us, library "
              + (f"{rec['library_device_ms'] * 1e3:.2f} us"
                 if rec["library_device_ms"] is not None else "n/a")
              + f", bound {rec['bound_ms'] * 1e3:.3f} us")
        record[kname].update(offline_rows=F,
                             offline_device_ms=rec["device_ms"],
                             offline_plain_device_ms=rec["plain_device_ms"],
                             offline_library_device_ms=rec[
                                 "library_device_ms"])
    print(f"[offline] phase seconds {time.perf_counter() - t0:.1f}")

    # 9. streamed == offline on the card, every vocoder mode
    t0 = time.perf_counter()
    stream_vs_offline_phase(cfg, voc_params, x, dev)
    print(f"[stream-offline] phase seconds {time.perf_counter() - t0:.1f}")

    # 10. the ddsp and wave streams and a 48 kHz client
    t0 = time.perf_counter()
    stream_launches = streams_phase(cfg, voc_params, dev)
    print(f"[streams] phase seconds {time.perf_counter() - t0:.1f}")

    # 11. the analysis kernels one row past the offline width
    t0 = time.perf_counter()
    cases = kernel_cases(F + 1, cfg, dev, rng)
    for kname in ANALYSIS_KERNELS:
        kernel_phase(kname, F + 1, cfg.dsp.fft_size, cases[kname],
                     timed=False)
    print(f"[kernel] ragged offline width: phase seconds "
          f"{time.perf_counter() - t0:.1f}")

    # 12. batched serving at 64 streams, float32
    t0 = time.perf_counter()
    batched_launches, batched_out, batched_voicing = batched_phase(cfg)
    print(f"[batched] phase seconds {time.perf_counter() - t0:.1f}")

    # 13. serving throughput, bf16
    t0 = time.perf_counter()
    serving = throughput_phase(cfg)
    print(f"[serve] phase seconds {time.perf_counter() - t0:.1f}")
    for kname in FORWARD_KERNELS:
        us, _ = serving[BATCH_STREAMS]["port"][kname]
        record[kname].update(batched_rows=20 * BATCH_STREAMS,
                             batched_device_ms=(None if us is None
                                                else us / 1e3))

    # 14. the socket server, 15. the pipelined stream and its soak, 16. a
    # 48 kHz client's first chunk
    t0 = time.perf_counter()
    socket_phase(cfg)
    print(f"[socket] phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    pipelined_phase(cfg)
    print(f"[pipelined] phase seconds {time.perf_counter() - t0:.1f}")
    first_chunk_phase(cfg)

    # 17. the corpus training path and the quality recipe
    corpus_launches, quality_s = corpus_phase(cfg, dev, checked)

    # 18. two ranks on this card over torch.distributed
    t0 = time.perf_counter()
    multihost_launches = multihost_phase(cfg, dev, checked, batched_out,
                                         batched_voicing)
    print(f"[multihost] phase seconds {time.perf_counter() - t0:.1f}")

    # 19. the captured programs: replay == eager, and side by side
    t0 = time.perf_counter()
    captured_phase(cfg)
    print(f"[captured] phase seconds {time.perf_counter() - t0:.1f}")

    # 20. the captured training steps and the analysis and synthesis
    # programs: replay == eager, and side by side
    t0 = time.perf_counter()
    captured_train = captured_training_phase(cfg, dev, quality_s)
    print(f"[captured-train] phase seconds {time.perf_counter() - t0:.1f}")

    # 21. the step's cost, on the card and the CPU, and the 20 ms profile
    t0 = time.perf_counter()
    _, cost_launches = cost_phase(cfg, checked)
    print(f"[cost] phase seconds {time.perf_counter() - t0:.1f}")

    # 22. the hifigan mode's captured server
    t0 = time.perf_counter()
    hifigan_launches = hifigan_phase(checked, dev)
    print(f"[hifigan] phase seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    bigvgan_launches = bigvgan_phase(checked, dev)
    print(f"[bigvgan] phase seconds {time.perf_counter() - t0:.1f}")

    # 23. kernels line (launches: every path's run — the default stream,
    # training, offline in each mode, the ddsp/wave/client-rate streams,
    # the batched server, corpus preparation, corpus training, the quality
    # recipe, the ranks' serving and training, phase 20's training
    # replays and analyses, phase 21's 20 ms stream and server, and phase
    # 22's hifigan and bigvgan servers), 24. result line
    paths = [launches, train_launches, *offline_launches.values(),
             *stream_launches.values(), batched_launches,
             *corpus_launches.values(), *multihost_launches.values(),
             captured_train["launches"], cost_launches, hifigan_launches,
             bigvgan_launches]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": [k.source for k in cuda.KERNELS if k.computes == name],
         "replaces": REPLACES[name],
         "launches": sum(p[name] for p in paths),
         **record[name]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == MH_FLAG:
        sys.exit(multihost_worker(sys.argv[2], int(sys.argv[3]),
                                  int(sys.argv[4]), int(sys.argv[5]),
                                  sys.argv[6], sys.argv[7]))
    sys.exit(main())
