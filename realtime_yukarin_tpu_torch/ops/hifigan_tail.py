"""The HiFi-GAN generator's tail between two convolutions: one fused pass,
the CUDA kernel ``csrc/hifigan_tail.cu`` and its plain version.

The generator (``models/vocoder_hifigan.py``) keeps its activations
channels-last, [rows, T, C], runs its convolutions without a bias, and
finishes each one here: the bias, the residual add, the resblocks' sum and
mean and the leaky ReLU in one read of each operand and one write of each
result.  Five modes (``y`` the convolution's output, ``b`` its bias, ``r``
the residual, ``acc`` the stage's resblock sum)::

    act   lrelu(y + b)                           conv_pre, each c1 conv
    up    h = y + b, lrelu(h)                    each transposed conv
    res   x = r + (y + b), lrelu(x)              a c2 conv, not the last
    sum   [acc +] (r + (y + b))                  a resblock's last c2 conv
    mean  lrelu(([acc +] (r + (y + b))) / n)     the stage's last resblock's

Every operand is [rows, Ty, C] and a pass may keep a window of its rows,
``length`` of them from row ``start`` (all by default): the results are
[rows, length, C].  The generator keeps each layer to the rows its kept
samples depend on (``VocoderHiFiGANConfig.cone``): conv_pre's act and each
upsample's up keep the rows the stage runs over, a stage's mean the rows
the next conv reads.

On CUDA tensors :func:`hifigan_tail` launches the kernel (bfloat16 or
float32 activations, C a multiple of 8, 16-byte aligned) or raises; on CPU
tensors it runs :func:`hifigan_tail_plain`, which takes any C and dtype.
Both compute in float32 (float64 for float64 activations) with a float32
bias and round once per stored value, and they order every sum alike, so
they agree bit for bit.

A cost count (``utils/cost.py``) sees each call as one launch of
``hifigan_tail`` at the shape (rows, length, C, the mode's index in
:data:`MODES`, y's samples a row: more than ``length`` where the crop
applies, the window's start) with :func:`hifigan_tail_cost` (no FLOPs, as
the count leaves out every elementwise op, and the bytes the kernel
moves).
"""

from __future__ import annotations

import torch

from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.utils import cost

MODES = ("act", "up", "res", "sum", "mean")
# what each mode reads and writes besides y, as [rows, T, C] tensors
_READS_R = {"res", "sum", "mean"}
_TWO_OUT = {"up", "res"}
ALIGN = 16          # bytes of the kernel's vector loads and stores
VECTOR = 8          # channels a group of the kernel holds (bfloat16)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``like``'s device: on CUDA, torch
    divides by a host scalar as a product with its reciprocal, which is
    not the kernel's division."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _lrelu(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v > 0, v, v * _scalar(slope, v))


def hifigan_tail_plain(mode: str, y: torch.Tensor, bias: torch.Tensor,
                       r: torch.Tensor | None = None,
                       acc: torch.Tensor | None = None, slope: float = 0.1,
                       divisor: float = 1.0, length: int | None = None,
                       start: int = 0) -> tuple[torch.Tensor, ...]:
    """The tail in ``mode`` by plain ops: y, r and acc [rows, Ty, C] in one
    dtype, ``length`` samples a row kept from ``start`` (all by default),
    bias [C].  Returns (out0,) or (out0, out1), [rows, length, C] in y's
    dtype; "sum" with ``acc`` and no crop writes into it and returns
    it."""
    f = torch.promote_types(y.dtype, torch.float32)
    length = y.shape[1] - start if length is None else length
    rows = slice(start, start + length)
    v = y[:, rows].to(f) + bias.to(f)
    if mode == "act":
        return (_lrelu(v, slope).to(y.dtype),)
    if mode == "up":
        return v.to(y.dtype), _lrelu(v, slope).to(y.dtype)
    v = r[:, rows].to(f) + v
    if mode == "res":
        return v.to(y.dtype), _lrelu(v, slope).to(y.dtype)
    if acc is not None:
        v = acc[:, rows].to(f) + v
    if mode == "mean":
        return (_lrelu(v / _scalar(divisor, v), slope).to(y.dtype),)
    if acc is not None:
        return (acc.copy_(v),)
    return (v.to(y.dtype),)


def hifigan_tail_cost(mode: str, rows: int, length: int, C: int,
                      element_bytes: int, with_acc: bool = False
                      ) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch: no FLOPs counted (an elementwise
    pass); y (its kept samples), each operand read and each result
    written once, and the float32 bias."""
    tensors = {"act": 2, "up": 3, "res": 4, "sum": 3, "mean": 3}[mode]
    if mode in ("sum", "mean") and with_acc:
        tensors += 1
    return 0, tensors * rows * length * C * element_bytes + 4 * C


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device
           ) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"hifigan_tail: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"hifigan_tail: {name} is {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"hifigan_tail: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"hifigan_tail: {name} on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"hifigan_tail: {name} must be contiguous")


def hifigan_tail(mode: str, y: torch.Tensor, bias: torch.Tensor,
                 r: torch.Tensor | None = None,
                 acc: torch.Tensor | None = None, slope: float = 0.1,
                 divisor: float = 1.0, length: int | None = None,
                 start: int = 0) -> tuple[torch.Tensor, ...]:
    """The tail in ``mode`` (:func:`hifigan_tail_plain`'s arguments and
    results): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if mode not in MODES:
        raise ValueError(f"hifigan_tail: mode {mode!r}, expected one of "
                         f"{MODES}")
    if y.dim() != 3:
        raise ValueError(f"hifigan_tail: y must be [rows, T, C], got "
                         f"{tuple(y.shape)}")
    rows, Ty, C = y.shape
    length = Ty - start if length is None else length
    if not (0 <= start and 0 <= length and start + length <= Ty):
        raise ValueError(f"hifigan_tail: rows [{start}, {start + length}) "
                         f"outside [0, {Ty}]")
    dev = y.device
    _check("y", y, (rows, Ty, C), y.dtype, dev)
    _check("bias", bias, (C,), torch.promote_types(y.dtype, torch.float32),
           dev)
    if mode in _READS_R:
        _check("r", r, (rows, Ty, C), y.dtype, dev)
    elif r is not None:
        raise ValueError(f"hifigan_tail: mode {mode!r} reads no residual")
    if acc is not None:
        if mode not in ("sum", "mean"):
            raise ValueError(f"hifigan_tail: mode {mode!r} reads no sum")
        _check("acc", acc, (rows, Ty, C), y.dtype, dev)
        if mode == "sum" and length != Ty:
            raise ValueError("hifigan_tail: \"sum\" adds into acc in "
                             "place, which a crop cannot")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hifigan_tail: no kernel for device {dev}")
    with cost.kernel("hifigan_tail",
                     (rows, length, C, MODES.index(mode), Ty, start),
                     *hifigan_tail_cost(mode, rows, length, C,
                                        y.element_size(), acc is not None)):
        if dev.type == "cpu":
            return hifigan_tail_plain(mode, y, bias, r, acc, slope, divisor,
                                      length, start)
        return hifigan_tail_launch(mode, y, bias, r, acc, slope, divisor,
                                   length, start)


def hifigan_tail_launch(mode: str, y: torch.Tensor, bias: torch.Tensor,
                        r: torch.Tensor | None, acc: torch.Tensor | None,
                        slope: float, divisor: float, length: int,
                        start: int = 0) -> tuple[torch.Tensor, ...]:
    """Launch the kernel on tensors :func:`hifigan_tail` checked: raises
    for what the kernel does not take (C not a multiple of 8, a dtype other
    than bfloat16 and float32, tensors not on CUDA or not 16-byte
    aligned)."""
    rows, Ty, C = y.shape
    if C % VECTOR:
        raise ValueError(f"hifigan_tail: C = {C} channels; the kernel "
                         f"takes a multiple of {VECTOR} (16-byte vectors)")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"hifigan_tail: the kernel takes bfloat16 or "
                        f"float32 activations, got {y.dtype}")
    if y.device.type != "cuda":
        raise ValueError(f"hifigan_tail: the kernel takes CUDA tensors, "
                         f"got {y.device}")
    if rows * length * C >= 2 ** 31:
        raise ValueError("hifigan_tail: over 2**31 elements")
    shape = (rows, length, C)
    out0 = (acc if mode == "sum" and acc is not None
            else torch.empty(shape, dtype=y.dtype, device=y.device))
    out1 = (torch.empty(shape, dtype=y.dtype, device=y.device)
            if mode in _TWO_OUT else None)
    tensors = [t for t in (y, r, acc, bias, out0, out1) if t is not None]
    if any(t.data_ptr() % ALIGN for t in tensors):
        raise ValueError("hifigan_tail: every tensor must be 16-byte "
                         "aligned")

    def ptr(t):
        return None if t is None else t.data_ptr()
    cuda.HIFIGAN_TAIL.launch(ptr(y), ptr(r), ptr(acc), bias.data_ptr(),
                             out0.data_ptr(), ptr(out1), rows, length, C,
                             Ty * C, start, MODES.index(mode),
                             int(y.dtype == torch.bfloat16), slope, divisor)
    return (out0,) if out1 is None else (out0, out1)
