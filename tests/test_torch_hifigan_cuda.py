"""On the card only: the HiFi-GAN generator's fused tail
(``csrc/hifigan_tail.cu``) against its plain version in every mode, and a
captured hifigan server step at the published widths: replay equals eager
bit for bit, one tail launch per gap between two convolutions, and no cuDNN
layout transpose inside the generator's stages.  Imports no JAX, so it
collects on the GPU machine; skips where there is no GPU (a CUDA kernel has
no CPU mode).  There:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_hifigan_cuda.py``."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht

pytestmark = pytest.mark.cuda

STAGES = chip_smoke.hifigan_shapes(
    Config.from_dict({"vocoder_mode": "hifigan"}))
# ragged ones: a row count no block divides, with and without the crop, a
# window from a later row, a single row
RAGGED = [(37, STAGES[1][1], 256, STAGES[1][1] + 1, 0), (37, 40, 128, 40, 0),
          (37, 40, 128, 45, 3), (3, 7, 8, 8, 0), (3, 7, 8, 10, 2),
          (1, 1, 24, 1, 0)]
CASES = [("act", False), ("up", False), ("res", False), ("sum", False),
         ("sum", True), ("mean", False), ("mean", True)]
SERVE_LANES = 16
STEPS = 4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_the_stage_shapes_are_the_published_generators():
    """256 lanes of 63 frames (``chip_smoke.hifigan_shapes``), each layer
    over the rows the kept samples depend on: conv_pre's act at 512
    channels, then each stage's upsample and mean with their windows."""
    assert STAGES == [(256, 56, 512, 62, 3),
                      (256, 268, 256, 281, 6), (256, 148, 256, 268, 60),
                      (256, 583, 128, 592, 4), (256, 463, 128, 583, 60),
                      (256, 1384, 64, 1390, 4), (256, 1264, 64, 1384, 60),
                      (256, 2526, 32, 2528, 1), (256, 2406, 32, 2526, 60)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,T,C,Ty,start", STAGES + RAGGED)
def test_tail_kernel_equals_its_plain_version(device, rows, T, C, Ty,
                                              start, dtype):
    """Every mode keeping T of Ty samples a row from ``start`` (the sum
    into acc in place uncropped): bit for bit, one launch a call."""
    g = torch.Generator().manual_seed(rows * T + C + start)

    def t(*shape):
        return torch.randn(shape, generator=g).to(dtype).to(device)
    bias = torch.randn(C, generator=g).to(device)
    for mode, with_acc in CASES:
        Ty_, start_ = (T, 0) if mode == "sum" and with_acc else (Ty, start)
        y = t(rows, Ty_, C)
        r = t(rows, Ty_, C) if mode in ("res", "sum", "mean") else None
        acc = t(rows, Ty_, C) if with_acc else None
        want = ht.hifigan_tail_plain(mode, y, bias, r,
                                     None if acc is None else acc.clone(),
                                     0.1, 3.0, T, start_)
        before = cuda.HIFIGAN_TAIL.launches
        got = ht.hifigan_tail(mode, y, bias, r, acc, 0.1, 3.0, T, start_)
        torch.cuda.synchronize()
        assert cuda.HIFIGAN_TAIL.launches == before + 1
        assert len(got) == len(want)
        for a, w in zip(got, want):
            assert a.shape == (rows, T, C)
            assert torch.equal(a, w), (mode, with_acc)


def _server(device):
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    cfg = Config.from_dict({"vocoder_mode": "hifigan"})
    params = init_params(cfg, torch.Generator().manual_seed(0))
    server = BatchedServer(params, cfg, num_streams=SERVE_LANES,
                           vocoder_mode="hifigan", device=device)
    return cfg, server


def _chunks(server, k: int):
    rng = np.random.default_rng(k)
    x = 0.1 * rng.standard_normal((SERVE_LANES, server.chunk_samples))
    return torch.from_numpy(x.astype(np.float32))


def test_captured_hifigan_step_equals_eager_and_launches_each_tail_once(
        device):
    from realtime_yukarin_tpu_torch.parallel.serving import make_batched_step
    from realtime_yukarin_tpu_torch.streaming.state import (tree_leaves,
                                                            tree_map)
    cfg, server = _server(device)
    step = make_batched_step(cfg, vocoder_mode="hifigan")
    init = server._init_carry
    carries = tree_map(lambda c: c.expand(SERVE_LANES, *c.shape).clone(),
                       init)
    for k in range(STEPS):
        live = torch.ones(SERVE_LANES, dtype=torch.bool)
        live[1] = k != 2
        reset = torch.zeros(SERVE_LANES, dtype=torch.bool)
        reset[2] = k == 3
        c, lv, rs = (a.to(device) for a in (_chunks(server, k), live, reset))
        cuda.reset_counts()
        y = server.step_device(c, lv, rs).clone()
        torch.cuda.synchronize()
        if server.captured and k:
            assert cuda.HIFIGAN_TAIL.launches == chip_smoke.hifigan_tails(
                cfg)
        with torch.no_grad():
            y_ref, carries = step(server._params, init, carries, c,
                                  server._keys, lv, rs)
        assert torch.equal(y, y_ref), k
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(server._carries), tree_leaves(carries))), k
    assert server.captured
    assert server.program.kernel_launches["hifigan_tail"] == (
        chip_smoke.hifigan_tails(cfg)) == 77


def test_no_layout_transpose_inside_the_generator_stages(device):
    """One replay under torch.profiler: from the ``vocoder_s1`` marker to
    the ``vocoder`` marker before conv_post no cuDNN NCHW <-> NHWC kernel
    runs, and the tail kernel runs once per gap between two convolutions
    of the four stages.  conv_post (one output channel, which cuDNN's NHWC
    kernels pad to 8) is the one conv cuDNN still transposes around: one
    nhwcToNchw kernel after that marker."""
    from torch.profiler import ProfilerActivity, profile
    cfg, server = _server(device)
    c = _chunks(server, 0).to(device)
    for _ in range(3):
        server.step_device(c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.step_device(c)
        torch.cuda.synchronize()
    ops = sorted(((e.time_range.start, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda op: op[0])
    names = [name for _, name in ops]

    def after(stage, start=0):
        """The index of marker ``stage_<stage>`` from ``start`` on (an
        extern "C" kernel: a demangler may add "void " and "()")."""
        return next(i for i in range(start, len(names)) if re.fullmatch(
            rf"(?:void )?stage_{stage}(?:\(\))?", names[i]))
    begin = after("begin_vocoder_s1")
    post = after("begin_vocoder", begin)
    end = after("end", post)

    def transposes(window):
        return [n for n in window if "nchwToNhwc" in n or "nhwcToNchw" in n]
    assert not transposes(names[begin:post])
    assert len(transposes(names[post:end])) <= 1
    assert sum("tail_kernel" in n for n in names[begin:post]) == (
        chip_smoke.hifigan_tails(cfg) - 1)
