"""The BigVGAN generator's pass before an activation: the bias, the
residual add or the resblocks' sum and mean, then the anti-aliased
SnakeBeta activation, in one pass: the CUDA kernel ``csrc/bigvgan_act.cu``
and its plain version.

The generator (``models/vocoder_bigvgan.py``) keeps its activations
channels-last, [rows, T, C], runs its convolutions without a bias, and
finishes each one that an activation follows here (the others, with no
activation, in ``ops/hifigan_tail.py`` at slope 1).  The value before the
activation, from the convolution's output ``y``, its bias ``b``, the
residual ``r``, the stage's resblock sum ``acc`` and a divisor ``n`` (each
optional)::

    v = ([acc +] ([r +] (y [+ b]))) / n

and the activation of BigVGAN's ``Activation1d(SnakeBeta)`` with
log-scale parameters (alpha = exp(a), beta = exp(b) per channel, here
given as ``alpha`` and ``inv_beta`` = 1 / (beta + 1e-9))::

    Act(v) = Down2(SnakeBeta(Up2(v)))
    Up2(v):   vp = replicate_pad(v, 5, 5)
              u = 2 * conv_transpose1d(vp, f, stride 2)[15: -15]  # 2T
    SnakeBeta(u) = u + sin(alpha * u)^2 * inv_beta
    Down2(s): sp = replicate_pad(s, 5, 6); conv1d(sp, f, stride 2)  # T

with f :func:`act_filter`'s 12 taps, every channel apart.  An output row
reads the 5 rows of v on either side of its own (``REACH``).

A pass returns Act(v) (a first conv's output, before the second), or,
with ``keep_v``, v and Act(v) (v the new residual: the transposed conv's
output, a second conv's before the next dilation).  It keeps ``length``
rows from row ``start`` of the operands' first ``extent`` rows (all by
default); the activation pads by replication at those rows' edges alone,
which are the window's true edges where the generator's dependency cone
reaches them: elsewhere the rows the padding corrupts lie outside the rows
the next layer reads.

On CUDA tensors :func:`bigvgan_act` launches the kernel (bfloat16 or
float32 activations, C even, 4- or 8-byte aligned) or raises; on CPU
tensors it runs :func:`bigvgan_act_plain`, which takes any C and dtype.
Both compute v in float32 (float64 for float64 activations) from the
operands and a float32 bias, and the activation on that unrounded v,
rounding once per stored value.  The kernel's sine is the hardware's
(``__sinf``), so the two agree to float32 rounding, not bit for bit.

A cost count (``utils/cost.py``) sees each call as one launch of
``bigvgan_act`` at the shape (rows, length, C, operands read, whether v
is kept) with :func:`bigvgan_act_cost`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.ops.dft import device_const
from realtime_yukarin_tpu_torch.utils import cost

TAPS = 12           # the filters' length, BigVGAN's for a ratio of 2
REACH = 5           # input rows an output row reads on either side
# FLOPs an output element of the activation costs: the upsample's two
# samples of 6 taps and the downsample's 12 (24 multiply-adds), and per
# upsampled sample the snake's product, square, scale and add
ACT_FLOPS = 2 * (2 * 6 + 12) + 2 * 4
ALIGN = {torch.bfloat16: 4, torch.float32: 8}   # bytes of two channels


@functools.lru_cache(maxsize=1)
def act_filter() -> np.ndarray:
    """BigVGAN's ``kaiser_sinc_filter1d(0.25, 0.3, 12)``: a Kaiser-windowed
    sinc at cutoff 0.25 of the 2x rate, half-width 0.3, 12 taps at times
    -5.5 ... 5.5, window beta 0.1102 (A - 8.7) with A = 2.285 * 5 * pi *
    1.2 + 7.95 (4.6638), normalised to sum 1; float32."""
    half = TAPS // 2
    A = 2.285 * (half - 1) * np.pi * (4 * 0.3) + 7.95
    beta = 0.1102 * (A - 8.7)
    t = np.arange(-half, half) + 0.5
    f = 2 * 0.25 * np.kaiser(TAPS, beta) * np.sinc(2 * 0.25 * t)
    return (f / f.sum()).astype(np.float32)


def activation(v: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor
               ) -> torch.Tensor:
    """Act(v) of [rows, T, C] by plain ops, every row computed and padded
    by replication at row 0 and row T - 1; alpha and inv_beta [C] in v's
    dtype."""
    C = v.shape[-1]
    f = torch.from_numpy(act_filter()).to(v).expand(C, 1, TAPS)
    x = Fn.pad(v.transpose(1, 2), (REACH, REACH), mode="replicate")
    u = 2 * Fn.conv_transpose1d(x, f, stride=2, groups=C)
    u = u[..., 3 * REACH: -3 * REACH]
    s = u + torch.sin(alpha[:, None] * u) ** 2 * inv_beta[:, None]
    s = Fn.pad(s, (REACH, REACH + 1), mode="replicate")
    return Fn.conv1d(s, f, stride=2, groups=C).transpose(1, 2)


def _value(y, bias, r, acc, divisor, lo, hi, f):
    v = y[:, lo: hi].to(f)
    if bias is not None:
        v = v + bias.to(f)
    if r is not None:
        v = r[:, lo: hi].to(f) + v
    if acc is not None:
        v = acc[:, lo: hi].to(f) + v
    if divisor != 1.0:
        v = v / torch.tensor(divisor, dtype=f, device=v.device)
    return v


def bigvgan_act_plain(y: torch.Tensor, act: tuple,
                      bias: torch.Tensor | None = None,
                      r: torch.Tensor | None = None,
                      acc: torch.Tensor | None = None, divisor: float = 1.0,
                      keep_v: bool = False, start: int = 0,
                      length: int | None = None,
                      extent: int | None = None) -> tuple[torch.Tensor, ...]:
    """The pass by plain ops: y, r and acc [rows, Ty, C] in one dtype, the
    operand their first ``extent`` rows (all by default), ``length`` rows
    kept from ``start`` (the rest by default), ``act`` (alpha, inv_beta)
    and bias, each [C].  Returns (Act(v),) or, with ``keep_v``, (v,
    Act(v)), [rows, length, C] in y's dtype."""
    f = torch.promote_types(y.dtype, torch.float32)
    extent = y.shape[1] if extent is None else extent
    length = extent - start if length is None else length
    lo, hi = max(start - REACH, 0), min(start + length + REACH, extent)
    v = _value(y, bias, r, acc, divisor, lo, hi, f)
    a = activation(v, *(p.to(f) for p in act))
    kept = slice(start - lo, start - lo + length)
    a = a[:, kept].to(y.dtype).contiguous()
    if keep_v:
        return v[:, kept].to(y.dtype).contiguous(), a
    return (a,)


def bigvgan_act_cost(rows: int, length: int, C: int, element_bytes: int,
                     operands: int, keep_v: bool) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch: ``ACT_FLOPS`` an output element; the
    kept rows of each of the ``operands`` read (y, r, acc) and of each
    result written once, and the float32 bias, alpha and inv_beta."""
    n = rows * length * C
    return ACT_FLOPS * n, (operands + 1 + keep_v) * n * element_bytes + 12 * C


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device
           ) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"bigvgan_act: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"bigvgan_act: {name} is {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"bigvgan_act: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"bigvgan_act: {name} on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"bigvgan_act: {name} must be contiguous")


def bigvgan_act(y: torch.Tensor, act: tuple,
                bias: torch.Tensor | None = None,
                r: torch.Tensor | None = None,
                acc: torch.Tensor | None = None, divisor: float = 1.0,
                keep_v: bool = False, start: int = 0,
                length: int | None = None, extent: int | None = None
                ) -> tuple[torch.Tensor, ...]:
    """The pass (:func:`bigvgan_act_plain`'s arguments and results): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if y.dim() != 3:
        raise ValueError(f"bigvgan_act: y must be [rows, T, C], got "
                         f"{tuple(y.shape)}")
    rows, Ty, C = y.shape
    extent = Ty if extent is None else extent
    length = extent - start if length is None else length
    if not (0 <= start and 0 < length and start + length <= extent <= Ty):
        raise ValueError(f"bigvgan_act: rows [{start}, {start + length}) "
                         f"outside [0, {extent}) of {Ty}")
    dev = y.device
    f = torch.promote_types(y.dtype, torch.float32)
    _check("y", y, (rows, Ty, C), y.dtype, dev)
    for name, t in (("r", r), ("acc", acc)):
        if t is not None:
            _check(name, t, (rows, Ty, C), y.dtype, dev)
    if bias is not None:
        _check("bias", bias, (C,), f, dev)
    for name, t in zip(("alpha", "inv_beta"), act):
        _check(name, t, (C,), f, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bigvgan_act: no kernel for device {dev}")
    operands = 1 + (r is not None) + (acc is not None)
    with cost.kernel("bigvgan_act", (rows, length, C, operands, keep_v),
                     *bigvgan_act_cost(rows, length, C, y.element_size(),
                                       operands, keep_v)):
        if dev.type == "cpu":
            return bigvgan_act_plain(y, act, bias, r, acc, divisor, keep_v,
                                     start, length, extent)
        return bigvgan_act_launch(y, act, bias, r, acc, divisor, keep_v,
                                  start, length, extent)


def bigvgan_act_launch(y, act, bias, r, acc, divisor: float, keep_v: bool,
                       start: int, length: int, extent: int
                       ) -> tuple[torch.Tensor, ...]:
    """Launch the kernel on tensors :func:`bigvgan_act` checked: raises
    for what the kernel does not take (an odd C, a dtype other than
    bfloat16 and float32, tensors not on CUDA or misaligned)."""
    rows, Ty, C = y.shape
    if C % 2:
        raise ValueError(f"bigvgan_act: C = {C} channels; the kernel takes "
                         f"an even number (two channels a thread)")
    if y.dtype not in ALIGN:
        raise TypeError(f"bigvgan_act: the kernel takes bfloat16 or "
                        f"float32 activations, got {y.dtype}")
    if y.device.type != "cuda":
        raise ValueError(f"bigvgan_act: the kernel takes CUDA tensors, "
                         f"got {y.device}")
    if rows * Ty * C >= 2 ** 31:
        raise ValueError("bigvgan_act: over 2**31 elements")
    shape = (rows, length, C)
    out_v = (torch.empty(shape, dtype=y.dtype, device=y.device) if keep_v
             else None)
    out_a = torch.empty(shape, dtype=y.dtype, device=y.device)
    tensors = [t for t in (y, r, acc, out_v, out_a) if t is not None]
    if any(t.data_ptr() % ALIGN[y.dtype] for t in tensors):
        raise ValueError("bigvgan_act: every tensor must be aligned to two "
                         "channels")

    def ptr(t):
        return None if t is None else t.data_ptr()
    alpha, inv_beta = act
    cuda.BIGVGAN_ACT.launch(ptr(y), ptr(r), ptr(acc), ptr(bias), ptr(alpha),
                            ptr(inv_beta),
                            ptr(device_const(act_filter, like=alpha)),
                            ptr(out_v), ptr(out_a), rows, extent, Ty * C,
                            start, length, C,
                            int(y.dtype == torch.bfloat16), divisor)
    return (out_v, out_a) if keep_v else (out_a,)
