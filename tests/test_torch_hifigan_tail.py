"""The HiFi-GAN generator's fused tail (``ops/hifigan_tail.py``) and its
channels-last forward, on the CPU; imports no JAX.

* Each mode of the tail's plain version equals the unfused composition of
  torch ops it replaces (bias, crop, residual, the resblocks' sum and mean,
  both slopes), bit for bit in float32, keeping its operands' rows whole,
  cropped at the end or from a later start row.
* The channels-last generator equals the channels-first formulation it
  replaced (kept here as the witness: conv1d with the bias, leaky ReLUs,
  residual adds and the resblock mean as separate ops) within float32
  rounding.
* The wrapper refuses what the kernel does not take.
* A cost count sees one tail launch per gap between two convolutions.
"""

import pytest
import torch
import torch.nn.functional as Fn

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.vocoder_hifigan import (
    LRELU_SLOPE, POST_SLOPE, HiFiGANGenerator)
from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht
from realtime_yukarin_tpu_torch.utils import cost

ROWS, T, C = 3, 11, 16
TINY = {"vocoder_mode": "hifigan", "compute_dtype": "float32",
        "vocoder_hifigan": {"upsample_initial_channel": 64,
                            "resblock_kernel_sizes": [3, 5, 7],
                            "resblock_dilation_sizes": [[1, 3, 5], [1, 3],
                                                        [2]]}}
# float32 rounding of two summation orders of the same convolutions,
# relative to the output's RMS (2e-7 read here)
F32_TOL = 1e-5


def _operands(seed: int = 0, Ty: int = T + 1):
    """y, the bias, r and acc, each operand of Ty samples a row."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g)
    return t(ROWS, Ty, C), t(C), t(ROWS, Ty, C), t(ROWS, Ty, C)


def _unfused(mode, y, b, r, acc, slope, n, start=0):
    """What the generator computed before the fusion, op by op (a conv
    with its bias is y + b), over the operands' rows [start, start + T)."""
    rows = slice(start, start + T)
    h = y[:, rows] + b
    if mode == "act":
        return (Fn.leaky_relu(h, slope),)
    if mode == "up":
        return h, Fn.leaky_relu(h, slope)
    x = r[:, rows] + h
    if mode == "res":
        return x, Fn.leaky_relu(x, slope)
    s = x if acc is None else acc[:, rows] + x
    if mode == "sum":
        return (s,)
    return (Fn.leaky_relu(s / n, slope),)


MODE_CASES = [("act", False, LRELU_SLOPE), ("up", False, LRELU_SLOPE),
              ("res", False, LRELU_SLOPE), ("sum", False, LRELU_SLOPE),
              ("sum", True, LRELU_SLOPE), ("mean", False, LRELU_SLOPE),
              ("mean", True, LRELU_SLOPE), ("mean", True, POST_SLOPE)]
# each mode keeping T of T + 1 samples a row from row 0, then (but the sum
# into acc in place, which keeps every row) T of T + 3 from row 2
CASES = ([pytest.param(*c, 0, id="-".join(map(str, c)))
          for c in MODE_CASES]
         + [pytest.param(*c, 2, id="-".join(map(str, c)) + "-start2")
            for c in MODE_CASES if c[:2] != ("sum", True)])


@pytest.mark.parametrize("mode,with_acc,slope,start", CASES)
def test_plain_tail_equals_the_unfused_ops_in_float32(mode, with_acc,
                                                      slope, start):
    in_place = mode == "sum" and with_acc
    y, b, r, acc = _operands(Ty=T if in_place else T + 1 + start)
    reads_r = mode in ("res", "sum", "mean")
    want = _unfused(mode, y, b, r if reads_r else None,
                    acc if with_acc else None, slope, 3.0, start)
    got = ht.hifigan_tail(mode, y, b, r if reads_r else None,
                          acc.clone() if with_acc else None, slope=slope,
                          divisor=3.0, length=T, start=start)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == (ROWS, T, C) and a.dtype == torch.float32
        assert torch.equal(a, w)


def test_sum_adds_into_the_stage_sum_in_place():
    y, b, r, acc = _operands(1, T)
    (out,) = ht.hifigan_tail("sum", y, b, r, acc)
    assert out is acc
    with pytest.raises(ValueError, match="in place"):
        ht.hifigan_tail("sum", y, b, r, acc, length=T - 1)


def test_bfloat16_tail_rounds_once_per_stored_value():
    """In bfloat16 the operands are widened, the chain runs in float32 and
    each result is rounded once: the float32 chain on the same widened
    operands, rounded."""
    y, b, r, acc = (t.bfloat16() for t in _operands(2))
    b = b.float()
    got = ht.hifigan_tail("mean", y, b, r, acc, slope=POST_SLOPE,
                          divisor=3.0, length=T)[0]
    want = _unfused("mean", y.float(), b, r.float(), acc.float(),
                    POST_SLOPE, 3.0)[0].bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _channels_first(net: HiFiGANGenerator, x: torch.Tensor) -> torch.Tensor:
    """The formulation the channels-last forward replaced: [B, C, T]
    activations, conv1d with its bias, and every leaky ReLU, residual add
    and resblock mean as an op of its own."""
    def conv(h, layer, d=1):
        k = layer.kernel_size[0]
        return Fn.conv1d(h, layer.weight, layer.bias,
                         padding=d * (k - 1) // 2, dilation=d)
    cfg = net.cfg
    T_ = x.shape[-2]
    h = conv(x.transpose(1, 2), net.conv_pre)
    n = len(cfg.resblock_kernel_sizes)
    for i, (up, u) in enumerate(zip(net.ups, cfg.upsample_rates)):
        h = Fn.conv_transpose1d(
            Fn.leaky_relu(h, LRELU_SLOPE), up.weight, up.bias, stride=u,
            padding=(up.kernel_size[0] - u) // 2)[..., : T_ * u]
        T_ *= u
        acc = None
        for rb in net.resblocks[i * n: (i + 1) * n]:
            z = h
            for d, c1, c2 in zip(rb.dilations, rb.convs1, rb.convs2):
                t = conv(Fn.leaky_relu(z, LRELU_SLOPE), c1, d)
                z = z + conv(Fn.leaky_relu(t, LRELU_SLOPE), c2)
            acc = z if acc is None else acc + z
        h = acc / n
    y = conv(Fn.leaky_relu(h, POST_SLOPE), net.conv_post)
    return torch.tanh(y)[:, 0]


def _tiny_generator(seed: int = 4) -> HiFiGANGenerator:
    cfg = Config.from_dict(TINY)
    torch.manual_seed(seed)
    net = HiFiGANGenerator(cfg.vocoder_hifigan, cfg.dsp).eval()
    with torch.no_grad():
        for p in net.parameters():       # biases as large as the weights
            p.copy_(torch.randn(p.shape) / p.shape[-1] ** 0.5
                    if p.dim() == 1 else p)
    return net


def test_channels_last_generator_equals_the_channels_first_one():
    net = _tiny_generator()
    x = torch.randn((2, 9, 67), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = _channels_first(net, x)
        got = net(x, torch.float32)
    assert got.shape == want.shape == (2, 9 * 120)
    level = float(want.pow(2).mean().sqrt())
    assert level > 1e-2
    assert float((got - want).pow(2).mean().sqrt()) / level < F32_TOL


def test_packed_weights_follow_the_parameters_and_the_dtype():
    net = _tiny_generator()
    first = net.packed(torch.float32)
    assert net.packed(torch.float32) is first
    w = first.pre[0]
    assert w.shape == (64, 67, 1, 7)
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert net.packed(torch.bfloat16).pre[0].dtype == torch.bfloat16
    assert net.packed(torch.bfloat16).pre[1].dtype == torch.float32
    with torch.no_grad():
        net.conv_post.bias.add_(1.0)
    again = net.packed(torch.float32)
    assert again is not first
    assert torch.equal(again.post[1], net.conv_post.bias)


def test_a_cost_count_sees_one_tail_per_gap_between_convs():
    """conv_pre's, then per stage the upsample's and one after each
    resblock conv: 1 + 4 x (1 + 2 x 6) at TINY's dilations; no FLOPs of
    their own, so the count's FLOPs stay the convolutions'."""
    net = _tiny_generator()
    x = torch.zeros((2, 9, 67))
    with cost.StepCount() as count:
        net(x, torch.float32)
    tails = [k for k in count.kernels if k.name == "hifigan_tail"]
    assert len(tails) == 1 + 4 * (1 + 2 * 6)
    assert all(k.flops == 0 for k in tails)
    modes = [ht.MODES[k.shape[3]] for k in tails]
    assert modes.count("mean") == 4 and modes.count("up") == 4
    assert modes.count("sum") == 4 * 2
    # the shape records y's samples a row: one past the kept ones where an
    # odd stride's trailing sample is cropped, the kept ones elsewhere
    crops = [k.shape[4] - k.shape[1] for k in tails]
    assert [c for c, m in zip(crops, modes) if m == "up"] == [
        u % 2 for u in net.cfg.upsample_rates] == [1, 0, 1, 0]
    assert not any(c for c, m in zip(crops, modes) if m != "up")


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    y, b, r, _ = _operands()
    with pytest.raises(ValueError, match="multiple of 8"):
        ht.hifigan_tail_launch("act", y[..., :12].contiguous(), b[:12],
                               None, None, 0.1, 1.0, T)
    with pytest.raises(ValueError, match="CUDA"):
        ht.hifigan_tail_launch("act", y, b, None, None, 0.1, 1.0, T)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ht.hifigan_tail_launch("act", y.double(), b.double(), None, None,
                               0.1, 1.0, T)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ht.hifigan_tail("act", y.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        ht.hifigan_tail("act", y.transpose(0, 1), b)
    with pytest.raises(TypeError, match="bias"):
        ht.hifigan_tail("act", y.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="r has shape"):
        ht.hifigan_tail("res", y, b, r[:, :T].contiguous(), length=T)
    with pytest.raises(ValueError, match="outside"):
        ht.hifigan_tail("act", y, b, length=T, start=2)
    with pytest.raises(ValueError, match="reads no residual"):
        ht.hifigan_tail("act", y, b, r, length=T)
    with pytest.raises(ValueError, match="mode"):
        ht.hifigan_tail("gelu", y, b)
