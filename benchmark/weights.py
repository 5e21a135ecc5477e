"""Weights from the seed, made on the device in one call and handed alike
to the program and to the reference.

Every layer's kernel is normal with variance 1/fan_in (flax's lecun
normal, untruncated); the layers the models zero-initialise (their heads)
get ``head_scale`` times that, and every bias ``bias_scale`` times a unit
normal, so that each learned stage moves the output.  A wave decoder's
``frac_ratios`` keep their init value.  The F0 statistics are the
configuration's.  The result is ``{net: state_dict}`` plus ``f0_stats``,
keyed as both sides' modules name their tensors.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.models.voice_changer import NETS, stage_nets


def _layout(ref_cfg) -> list[tuple[str, str, tuple, float]]:
    """[(net, state-dict key, shape, scale or NaN for 'bias')]."""
    spec = []
    nets = stage_nets(ref_cfg)
    for k in NETS:
        net = nets[k]
        names = {id(m): n for n, m in net.named_modules()}
        for path, layer in net.flax_layers().items():
            mod = names[id(layer)]
            w = layer.weight
            std = 1.0 / math.sqrt(w[0].numel())
            head = path in net.ZERO_INIT
            spec.append((k, f"{mod}.weight", tuple(w.shape),
                         std, head))
            spec.append((k, f"{mod}.bias", tuple(layer.bias.shape),
                         math.nan, False))
    return spec


def make_weights(ref_cfg, spec: dict, seed: int, device) -> dict:
    """``{net: {key: tensor}, "f0_stats": {name: 0-d tensor}}`` on
    ``device``, float32 (the type the parameters are kept in)."""
    layout = _layout(ref_cfg)
    total = sum(math.prod(s) for _, _, s, _, _ in layout)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out: dict = {k: {} for k in NETS}
    i = 0
    for net, key, shape, std, head in layout:
        n = math.prod(shape)
        x = flat[i: i + n].view(shape)
        i += n
        if math.isnan(std):
            scale = spec["bias_scale"]
        else:
            scale = std * (spec["head_scale"] if head else 1.0)
        out[net][key] = x * scale
    out["vocoder_wave"]["frac_ratios"] = 0.5 + torch.arange(
        ref_cfg.vocoder_wave.phase_fractional, dtype=torch.float32,
        device=device)
    out["f0_stats"] = {k: torch.tensor(math.log(v) if k.endswith("mean")
                                       else v, dtype=torch.float32,
                                       device=device)
                       for k, v in spec["f0_stats"].items()}
    return out


def load_into(nets: dict, weights: dict) -> dict:
    """Modules ``nets`` holding copies of ``weights``' tensors (on their
    device), plus the F0 statistics: a parameter set."""
    out = {}
    for k in NETS:
        net = nets[k]
        net.load_state_dict({n: t.clone() for n, t in weights[k].items()},
                            assign=True)
        out[k] = net
    out["f0_stats"] = {k: v.clone() for k, v in weights["f0_stats"].items()}
    return out
