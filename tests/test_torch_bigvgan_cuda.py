"""On the card only: the BigVGAN generator's activation pass
(``csrc/bigvgan_act.cu``) against its plain version in every kind a stage
runs, the passes without an activation (``csrc/hifigan_tail.cu`` at slope
1) at the generator's shapes, and a captured bigvgan server step: replay
equals eager bit for bit, one pass launch per gap between two
convolutions.  Imports no JAX, so it collects on the GPU
machine; skips where there is no GPU (a CUDA kernel has no CPU mode).
There: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_bigvgan_cuda.py``."""

import numpy as np
import pytest
import torch

import chip_smoke
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.ops import bigvgan_act as ba
from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht

pytestmark = pytest.mark.cuda

CFG = Config.from_dict({"vocoder_mode": "bigvgan"})
STAGES = chip_smoke.bigvgan_shapes(CFG)
# (rows, kept, C, operand rows, y's rows, first kept): the published
# generator's at 4 lanes, and ragged ones: a channel tile cut short (96 =
# 64 + 32), two channels, windows at either edge of the operand and
# inside, the transposed conv's crop, a single row
SHAPES = ([(4, *s[1:]) for s in STAGES]
          + [(3, 37, 96, 40, 40, 0), (3, 37, 96, 40, 40, 3),
             (2, 9, 2, 12, 13, 1), (2, 40, 24, 45, 46, 5),
             (1, 1, 8, 1, 1, 0), (5, 33, 48, 70, 71, 37)])
KINDS = [("up", 1, True), ("act", 1, False), ("res", 2, True),
         ("mean", 3, False)]
SERVE_LANES = 4
STEPS = 3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_the_stage_shapes_are_the_published_generators():
    """128 lanes of 157 frames (``chip_smoke.bigvgan_shapes``), each layer
    over the rows the kept samples depend on: conv_pre's bias at 1536
    channels, then each stage's upsample and mean with their windows."""
    assert [s[1:3] for s in STAGES] == [
        (72, 1536), (349, 768), (169, 768), (502, 384), (322, 384),
        (642, 192), (462, 192), (922, 96), (742, 96), (1480, 48),
        (1300, 48), (2596, 24), (2406, 24)]
    assert chip_smoke.bigvgan_passes(CFG) == (127, 109)


def _snake(g, C, device):
    return (torch.exp(0.5 * torch.randn(C, generator=g)).to(device),
            torch.exp(0.5 * torch.randn(C, generator=g)).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,T,C,extent,Ty,start", SHAPES)
def test_pass_kernel_equals_its_plain_version(device, rows, T, C, extent,
                                              Ty, start, dtype):
    """Every kind keeping T of the operand's rows from ``start``: v bit for
    bit; the activation within chip_smoke.BIGVGAN_TOL of the plain
    version's peak in float32 (the SFU's sine), within one rounding and
    that in bfloat16; one launch a call."""
    g = torch.Generator().manual_seed(rows * T + C + start)
    for kind, operands, keep_v in KINDS:
        y, r, acc = (torch.randn((rows, Ty, C), generator=g).to(dtype)
                     .to(device) if k < operands else None
                     for k in range(3))
        bias = torch.randn(C, generator=g).to(device)
        args = (_snake(g, C, device), bias, r, acc,
                3.0 if kind == "mean" else 1.0, keep_v, start, T, extent)
        want = ba.bigvgan_act_plain(y, *args)
        before = cuda.BIGVGAN_ACT.launches
        got = ba.bigvgan_act(y, *args)
        torch.cuda.synchronize()
        assert cuda.BIGVGAN_ACT.launches == before + 1
        assert len(got) == len(want) == 1 + keep_v
        for a in got:
            assert a.shape == (rows, T, C) and a.dtype == dtype
        if keep_v:
            assert torch.equal(got[0], want[0]), kind
        k, p = got[-1].float(), want[-1].float()
        if dtype == torch.float32:
            err = float((k - p).abs().max() / p.abs().max())
            assert err <= chip_smoke.BIGVGAN_TOL, (kind, err)
        else:
            assert bool(((k - p).abs() <= 2.0 ** -7 * p.abs()
                         + chip_smoke.BIGVGAN_TOL * p.abs().max())
                        .all()), kind


@pytest.mark.parametrize("rows,T,C,extent,Ty,start",
                         [(4, *s[1:]) for s in STAGES])
def test_the_passes_without_an_activation(device, rows, T, C, extent, Ty,
                                          start):
    """conv_pre's bias, a block's sum (with and without the running sum)
    and a stage's mean: ``hifigan_tail`` at slope 1 bit for bit against
    its plain version at the generator's shapes, in bfloat16."""
    g = torch.Generator().manual_seed(rows * T + C)
    for mode, operands in (("act", 1), ("sum", 2), ("sum", 3),
                           ("mean", 3)):
        y, r, acc = (torch.randn((rows, Ty, C), generator=g).bfloat16()
                     .to(device) if k < operands else None
                     for k in range(3))
        bias = torch.randn(C, generator=g).to(device)
        keep = (Ty, 0) if mode == "sum" else (T, start)
        want = ht.hifigan_tail_plain(mode, y, bias, r, None if acc is None
                                     else acc.clone(), 1.0, 3.0, *keep)
        got = ht.hifigan_tail(mode, y, bias, r, acc, 1.0, 3.0, *keep)
        assert torch.equal(got[0], want[0]), mode
        if mode == "sum" and acc is not None:
            assert got[0].data_ptr() == acc.data_ptr()


def test_the_kernel_refuses_what_it_does_not_take(device):
    g = torch.Generator().manual_seed(1)
    y = torch.zeros((2, 8, 3), device=device)
    with pytest.raises(ValueError, match="even"):
        ba.bigvgan_act(y, _snake(g, 3, device))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ba.bigvgan_act(y[..., :2].contiguous().half(), _snake(g, 2, device))


def _server(device):
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    params = init_params(CFG, torch.Generator().manual_seed(0))
    return BatchedServer(params, CFG, num_streams=SERVE_LANES,
                         vocoder_mode="bigvgan", device=device)


def test_captured_bigvgan_step_equals_eager_and_launches_each_pass_once(
        device):
    from realtime_yukarin_tpu_torch.parallel.serving import make_batched_step
    from realtime_yukarin_tpu_torch.streaming.state import (tree_leaves,
                                                            tree_map)
    server = _server(device)
    step = make_batched_step(CFG, vocoder_mode="bigvgan")
    init = server._init_carry
    carries = tree_map(lambda c: c.expand(SERVE_LANES, *c.shape).clone(),
                       init)
    passes, with_act = chip_smoke.bigvgan_passes(CFG)
    for k in range(STEPS):
        rng = np.random.default_rng(k)
        c = torch.from_numpy((0.1 * rng.standard_normal(
            (SERVE_LANES, server.chunk_samples))).astype(np.float32))
        live = torch.ones(SERVE_LANES, dtype=torch.bool)
        live[1] = k != 1
        reset = torch.zeros(SERVE_LANES, dtype=torch.bool)
        reset[2] = k == 2
        c, lv, rs = (a.to(device) for a in (c, live, reset))
        cuda.reset_counts()
        y = server.step_device(c, lv, rs).clone()
        torch.cuda.synchronize()
        if server.captured and k:
            assert cuda.BIGVGAN_ACT.launches == with_act
            assert cuda.HIFIGAN_TAIL.launches == passes - with_act
        with torch.no_grad():
            y_ref, carries = step(server._params, init, carries, c,
                                  server._keys, lv, rs)
        assert torch.equal(y, y_ref), k
        assert bool(torch.isfinite(y).all())
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(server._carries), tree_leaves(carries))), k
    assert server.captured
    launched = server.program.kernel_launches
    assert (launched["bigvgan_act"], launched["hifigan_tail"]) == (109, 18)
