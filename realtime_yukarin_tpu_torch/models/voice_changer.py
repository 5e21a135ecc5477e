"""Parameters of the model stages, both neural vocoders and the F0 transform
(PyTorch port of ``models/voice_changer.py``).

The port's parameter set is a dict ``{"stage1": AcousticNet, "stage2":
SRNet, "vocoder": VocoderControlNet, "vocoder_wave": WaveDecoderNet,
"f0_stats": {src_mean, src_std, tgt_mean, tgt_std}}`` (0-d float32
tensors).  Weights cross to and from the JAX package in its ``.npz`` layout
— ``flatten_params``' slash-joined flax paths such as
``stage1/params/block_0/conv/kernel`` — through :func:`params_from_jax`
(strict like ``unflatten_params``) and :func:`params_to_jax`.

A vocoder mode's own net (``models/vocoders.py``: the hifigan mode's
``"vocoder_hifigan"``, the bigvgan mode's ``"vocoder_bigvgan"``) is built
(:func:`init_params`) and loaded
(:func:`load_all_params`) in that mode only.  The JAX package has none, so
it is not in ``NETS`` or the ``.npz`` layout; a full-tree load keeps it.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn as nn

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.dsp.mcep import decode_mcep
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature
from realtime_yukarin_tpu_torch.models.acoustic import AcousticNet, convert_mc
from realtime_yukarin_tpu_torch.models.f0_stats import F0Statistics
from realtime_yukarin_tpu_torch.models.initializers import init_module
from realtime_yukarin_tpu_torch.models.super_resolution import (
    SRNet, refine_envelope)
from realtime_yukarin_tpu_torch.models.vocoder_nn import VocoderControlNet
from realtime_yukarin_tpu_torch.models.vocoder_wave import WaveDecoderNet
from realtime_yukarin_tpu_torch.models.vocoders import (EXTRA_NETS,
                                                        VOCODERS, vocoder)

F0_STAT_NAMES = ("src_mean", "src_std", "tgt_mean", "tgt_std")
NETS = ("stage1", "stage2", "vocoder", "vocoder_wave")


def stage_nets(cfg: Config) -> dict[str, nn.Module]:
    """Uninitialised modules of every stage, in ``NETS`` order."""
    return {"stage1": AcousticNet(cfg.acoustic, cfg.dsp.mc_dim),
            "stage2": SRNet(cfg.super_resolution, cfg.dsp.spec_bins),
            "vocoder": VocoderControlNet(cfg.vocoder_nn, cfg.dsp),
            "vocoder_wave": WaveDecoderNet(cfg.vocoder_wave, cfg.dsp)}


def init_params(cfg: Config, generator: torch.Generator,
                device="cpu", vocoder_mode: str | None = None) -> dict:
    """Fresh parameters with the JAX ``init_params`` shapes for all five
    subtrees: lecun-normal kernels, zero biases, zero heads (so both stages
    are the identity and both vocoders the DSP renderer until trained).
    A mode with a net of its own (``vocoder_mode``, else the config's;
    the hifigan mode's generator) adds it, drawn after the rest.
    Inference copy on ``device`` (see :func:`params_to`)."""
    nets = {k: init_module(net, generator)
            for k, net in stage_nets(cfg).items()}
    net = vocoder(vocoder_mode or cfg.resolved_vocoder_mode).net
    if net is not None:
        nets[net[0]] = init_module(net[1](cfg), generator)
    f0_stats = {"src_mean": math.log(160.0), "src_std": 0.25,
                "tgt_mean": math.log(160.0), "tgt_std": 0.25}
    return params_to({**nets, "f0_stats": {
        k: torch.tensor(v, dtype=torch.float32)
        for k, v in f0_stats.items()}}, device)


def _copy(params: dict, device, trainable: bool) -> dict:
    device = torch.device(device)
    nets = {}
    for k in NETS + EXTRA_NETS:
        if k in params:
            net = copy.deepcopy(params[k]).to(device)
            nets[k] = (net.train() if trainable else net.eval()
                       ).requires_grad_(trainable)
    stats = {k: v.detach().to(device).clone().requires_grad_(trainable)
             for k, v in params["f0_stats"].items()}
    return {**nets, "f0_stats": stats}


def params_to(params: dict, device) -> dict:
    """A frozen copy of ``params`` on ``device`` for inference (the
    caller's modules are left as they are)."""
    return _copy(params, device, trainable=False)


def params_trainable(params: dict, device) -> dict:
    """A trainable copy of ``params`` on ``device``: every module's
    parameters and every ``f0_stats`` scalar are leaves that require
    grad (the caller's tensors are left as they are)."""
    return _copy(params, device, trainable=True)


def param_leaves(params: dict) -> dict[str, list[torch.Tensor]]:
    """{top-level subtree: its tensors}, the unit of per-stage clipping;
    modules in ``parameters()`` order, ``f0_stats`` in ``F0_STAT_NAMES``
    order."""
    out = {}
    for k, v in params.items():
        out[k] = (list(v.parameters()) if isinstance(v, nn.Module)
                  else [v[n] for n in F0_STAT_NAMES])
    return out


def convert_f0_stats(f0: torch.Tensor, stats: dict) -> torch.Tensor:
    """Voiced-masked log-linear F0 moment matching; unvoiced stays 0."""
    voiced = f0 > 0
    logf0 = torch.log(torch.clamp(f0, min=1e-6))
    out = torch.exp((logf0 - stats["src_mean"])
                    / torch.clamp(stats["src_std"], min=1e-6)
                    * stats["tgt_std"] + stats["tgt_mean"])
    return torch.where(voiced, out, torch.zeros_like(out))


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def convert_features(params: dict, feat: AcousticFeature, cfg: Config,
                     use_sr: bool = True, dtype=None,
                     envelope: bool = True) -> AcousticFeature:
    """feature -> converted feature: F0 moment matching, stage-1 mc
    mapping, mc -> envelope decode, stage-2 envelope super-resolution;
    aperiodicity passes through.  Frame-major [T, ...] or [B, T, ...].
    ``envelope`` False (a mode that reads none): no decode and no SR."""
    if dtype is None:
        dtype = compute_dtype(cfg)
    f0c = convert_f0_stats(feat.f0, params["f0_stats"])
    mc_c = convert_mc(params["stage1"], feat.mc, feat.f0, cfg.acoustic,
                      dtype)
    if not envelope:
        return AcousticFeature(f0=f0c, env=None, ap=feat.ap, mc=mc_c)
    env_low = decode_mcep(mc_c, cfg.dsp)
    env_c = (refine_envelope(params["stage2"], env_low, cfg.super_resolution,
                             cfg.dsp, dtype) if use_sr else env_low)
    return AcousticFeature(f0=f0c, env=env_c, ap=feat.ap, mc=mc_c)


def convert_window(params: dict, feat: AcousticFeature, cfg: Config,
                   t0: int, out_frames: int, vocoder_halo: int = 0,
                   use_sr: bool = True, dtype=None) -> AcousticFeature:
    """:func:`convert_features` for window frames [t0 - vocoder_halo,
    t0 + out_frames + vocoder_halo) only, each stage on the slice its
    receptive field requires (SAME-padded convs equal the full-window
    computation on any interior slice): super-resolution sees its own
    ``context_frames`` halo around the range, stage 1 the whole window.
    ``feat`` is [T, ...]."""
    if dtype is None:
        dtype = compute_dtype(cfg)
    ctx_sr = cfg.super_resolution.context_frames if use_sr else 0
    s = t0 - vocoder_halo
    Lv = out_frames + 2 * vocoder_halo
    f0c = convert_f0_stats(feat.f0, params["f0_stats"])
    mc_c = convert_mc(params["stage1"], feat.mc, feat.f0, cfg.acoustic,
                      dtype)
    env_low = decode_mcep(mc_c[s - ctx_sr: s + Lv + ctx_sr], cfg.dsp)
    if use_sr:
        env_v = refine_envelope(params["stage2"], env_low,
                                cfg.super_resolution, cfg.dsp,
                                dtype)[ctx_sr: ctx_sr + Lv]
    else:
        env_v = env_low
    return AcousticFeature(f0=f0c[s: s + Lv], env=env_v,
                           ap=feat.ap[s: s + Lv], mc=mc_c[s: s + Lv])


# ---------------------------------------------------------------------------
# The JAX ``.npz`` layout
# ---------------------------------------------------------------------------

def flax_tensors(net: nn.Module) -> dict[str, torch.Tensor]:
    """flax path under ``params/`` -> the module's tensor: ``<layer>/kernel``
    (a conv weight [out, in, k] is flax's [k, in, out], a dense weight
    [out, in] its [in, out]: the reversed axes), ``<layer>/bias``, and the
    module's plain parameters (``flax_params``).  A layer without bias
    has no ``bias``."""
    out = {}
    for path, layer in net.flax_layers().items():
        out[f"{path}/kernel"] = layer.weight
        if layer.bias is not None:
            out[f"{path}/bias"] = layer.bias
    if hasattr(net, "flax_params"):
        out.update(net.flax_params())
    return out


def _to_flax(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float32)
    return np.transpose(a) if name.endswith("/kernel") else a


def _expected(cfg: Config) -> dict[str, tuple]:
    """flax name -> flax shape, for every leaf the port carries."""
    out = {}
    for stage, net in stage_nets(cfg).items():
        for path, t in flax_tensors(net).items():
            out[f"{stage}/params/{path}"] = np.shape(_to_flax(path, t))
    for name in F0_STAT_NAMES:
        out[f"f0_stats/{name}"] = ()
    return out


def load_flax(net: nn.Module, flat: dict, prefix: str = "params/") -> None:
    """Copy ``flat[prefix + path]`` into each of ``net``'s tensors
    (:func:`flax_tensors`); strict: a missing, extra or mis-shaped name
    raises."""
    tensors = flax_tensors(net)
    names = {prefix + p for p in tensors}
    missing = sorted(names - set(flat))
    extra = sorted(set(flat) - names)
    if missing or extra:
        raise ValueError(f"npz params mismatch: missing={missing[:8]} "
                         f"extra={extra[:8]}")
    with torch.no_grad():
        for path, t in tensors.items():
            value = np.array(flat[prefix + path], np.float32)
            if path.endswith("/kernel"):
                value = np.transpose(value)
            if value.shape != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for {prefix + path}: file "
                    f"{np.shape(flat[prefix + path])} vs model "
                    f"{np.shape(_to_flax(path, t))}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def params_from_jax(flat: dict, cfg: Config, device="cpu") -> dict:
    """Fill the port's parameters from the JAX ``flatten_params`` layout.

    Strict: a missing, extra or mis-shaped name under any of the five
    subtrees raises.  Returns the params on ``device``."""
    names = set(flat)
    expected = _expected(cfg)
    missing = sorted(set(expected) - names)
    extra = sorted(names - set(expected))
    if missing or extra:
        raise ValueError(f"npz params mismatch: missing={missing[:8]} "
                         f"extra={extra[:8]}")
    for name, shape in expected.items():
        got = tuple(np.shape(flat[name]))
        if got != shape:
            raise ValueError(f"shape mismatch for {name}: file {got} vs "
                             f"model {shape}")
    params = {}
    for stage, net in stage_nets(cfg).items():
        load_flax(net, {k[len(stage) + 1:]: v for k, v in flat.items()
                        if k.startswith(stage + "/")})
        params[stage] = net
    params["f0_stats"] = {n: torch.tensor(np.float32(flat[f"f0_stats/{n}"]))
                          for n in F0_STAT_NAMES}
    return params_to(params, device)


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: {flax name: float32 array}
    in the ``flatten_params`` layout, which the JAX package's
    ``unflatten_params`` / ``load_params`` take strictly."""
    out = {}
    for stage in NETS:
        for path, t in flax_tensors(params[stage]).items():
            out[f"{stage}/params/{path}"] = _to_flax(path, t)
    for n in F0_STAT_NAMES:
        out[f"f0_stats/{n}"] = _to_flax(n, params["f0_stats"][n])
    return out


def save_params_npz(params: dict, path: str) -> None:
    """Write ``params`` as the JAX package's ``.npz`` snapshot."""
    if not str(path).endswith(".npz"):
        raise ValueError(f"{path}: the port writes .npz snapshots only")
    np.savez(path, **params_to_jax(params))


_MSGPACK_NDARRAY = 1      # flax.serialization's ext type codes
_MSGPACK_NPSCALAR = 3


def _msgpack_ext(code: int, data: bytes):
    import msgpack
    if code == _MSGPACK_NDARRAY:
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())
                             ).reshape(shape)
    if code == _MSGPACK_NPSCALAR:
        dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode()))[0]
    raise ValueError(f"msgpack ext type {code} is not a flax array")


def _flatten_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _read_msgpack(path: str) -> dict:
    """A flax ``.msgpack`` snapshot (``flax.serialization.to_bytes`` of a
    state dict: nested string-keyed maps whose leaves are ext type 1,
    ``(shape, dtype name, C-order bytes)``, or ext type 3 for NumPy
    scalars) as the slash-joined ``flatten_params`` layout, without flax.
    """
    try:
        import msgpack
    except ImportError as e:
        raise ValueError(
            f"{path}: reading a .msgpack snapshot needs the msgpack module, "
            f"which is not installed; without it the port reads parameters "
            f"in the JAX package's .npz layout only (written by "
            f"`cli.train --export_params x.npz` of either package, or the "
            f"JAX package's save_params(params, 'x.npz'))") from e
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_msgpack_ext, raw=False)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax state dict")
    return _flatten_tree(tree)


def _read_params(path: str) -> dict:
    """{flax name: array} from a JAX package snapshot: ``.npz``, or flax
    ``.msgpack`` (every other suffix, as the JAX package's
    ``load_params`` reads it)."""
    if not str(path).endswith(".npz"):
        return _read_msgpack(path)
    with np.load(path, allow_pickle=False) as d:
        return dict(d)


def load_params_npz(path: str, cfg: Config, device="cpu") -> dict:
    """Strict loader for the JAX package's ``.npz`` and ``.msgpack``
    snapshots (see :func:`params_from_jax`)."""
    return params_from_jax(_read_params(path), cfg, device)


def load_all_params(params: dict, cfg: Config,
                    params_path: str | None = None) -> dict:
    """Apply every params/statistics path the config names (plus an
    explicit ``params_path``) to ``params``; returns new params on their
    device, the caller's are left as they are.

    Order (later wins): cfg.params_path (full tree) -> ``params_path``
    (full tree) -> per-stage subtree files (``<net>_params_path`` for
    stage1/stage2/vocoder/vocoder_wave and each mode's own net, each the
    ``flatten_params`` layout of that subtree) -> the F0 statistics
    ``.npz`` files (``mean``, ``std``).
    Every parameter file is read strictly, as ``.npz`` or flax
    ``.msgpack``."""
    device = params["f0_stats"]["src_mean"].device
    kept = {k: params[k] for k in EXTRA_NETS if k in params}
    for full in (cfg.params_path, params_path):
        if full:
            params = {**load_params_npz(full, cfg, device), **kept}
    params = params_to(params, device)
    for mode, voc in VOCODERS.items():
        key = voc.net and voc.net[0]
        if key and getattr(cfg, f"{key}_params_path") and key not in params:
            raise ValueError(f"{key}_params_path names the {mode} mode's "
                             f"generator, and the params hold none: build "
                             f"them in that mode (init_params(..., "
                             f"vocoder_mode='{mode}'))")
    for key in NETS + EXTRA_NETS:
        path = getattr(cfg, f"{key}_params_path")
        if path:
            load_flax(params[key], _read_params(path))
    for path, mean_key, std_key in (
            (cfg.input_statistics_path, "src_mean", "src_std"),
            (cfg.target_statistics_path, "tgt_mean", "tgt_std")):
        if path:
            stats = F0Statistics.load(path)
            for k, v in ((mean_key, stats.mean), (std_key, stats.std)):
                params["f0_stats"][k] = torch.tensor(
                    v, dtype=torch.float32, device=device)
    return params
