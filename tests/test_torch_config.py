"""The port's configuration equals the JAX package's, apart from what the
port alone has (the HiFi-GAN and BigVGAN vocoder modes: the
``vocoder_hifigan`` and ``vocoder_bigvgan`` sections and their params
paths), and the port imports nothing of JAX, flax or the JAX package."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest

from realtime_yukarin_tpu import config as jconfig
from realtime_yukarin_tpu_torch import config as tconfig

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "realtime_yukarin_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "realtime_yukarin_tpu")
PORT_ONLY = ("vocoder_hifigan", "vocoder_hifigan_params_path",
             "vocoder_bigvgan", "vocoder_bigvgan_params_path")


def _jax_keys(d: dict) -> dict:
    """A port config dict without the keys only the port has."""
    return {k: v for k, v in d.items() if k not in PORT_ONLY}


def _properties(obj) -> dict:
    return {name: getattr(obj, name) for name in dir(type(obj))
            if isinstance(getattr(type(obj), name), property)}


def _variant(mod):
    return mod.Config(dsp=mod.DspConfig(max_harmonics=128),
                      streaming=mod.StreamingConfig(chunk_ms=40.0))


@pytest.mark.parametrize("make", [lambda m: m.Config(), _variant],
                         ids=["default", "40ms_h128"])
def test_config_fields_and_properties_match_jax(make):
    j, t = make(jconfig), make(tconfig)
    assert dataclasses.asdict(j) == _jax_keys(dataclasses.asdict(t))
    assert set(dataclasses.asdict(t)) - set(dataclasses.asdict(j)) == set(
        PORT_ONLY)
    for part in ("dsp", "acoustic", "super_resolution", "vocoder_nn",
                 "vocoder_wave", "streaming", "serving"):
        jp, tp = getattr(j, part), getattr(t, part)
        assert _properties(jp) == _properties(tp), part
    assert (j.streaming.chunk_samples(j.dsp)
            == t.streaming.chunk_samples(t.dsp))
    assert j.streaming.chunk_frames(j.dsp) == t.streaming.chunk_frames(t.dsp)
    assert j.resolved_vocoder_mode == t.resolved_vocoder_mode
    # the properties the streaming geometry is built from
    for name in ("hop", "spec_bins", "num_harmonics", "f0_edge_frames",
                 "f0_left_frames", "f0_frame_len", "voicing_energy_win"):
        assert getattr(j.dsp, name) == getattr(t.dsp, name), name
    assert j.acoustic.context_frames == t.acoustic.context_frames


@pytest.mark.parametrize("args", [(False, None), (True, None),
                                  (False, "wave"), (True, "dsp")])
def test_resolve_vocoder_mode_matches_jax(args):
    assert (jconfig.resolve_vocoder_mode(*args)
            == tconfig.resolve_vocoder_mode(*args))


def test_resolve_vocoder_mode_takes_hifigan_in_the_port_only():
    assert tconfig.resolve_vocoder_mode(False, "hifigan") == "hifigan"
    assert tconfig.resolve_vocoder_mode(True, "hifigan") == "hifigan"
    assert tconfig.Config(vocoder_mode="hifigan").resolved_vocoder_mode \
        == "hifigan"
    with pytest.raises(ValueError):
        jconfig.resolve_vocoder_mode(False, "hifigan")
    with pytest.raises(ValueError, match="hifigan"):
        tconfig.resolve_vocoder_mode(False, "melgan")


def test_config_from_dict_round_trip():
    d = jconfig.Config(compute_dtype="float32").to_dict()
    assert _jax_keys(tconfig.Config.from_dict(d).to_dict()) == d
    with pytest.raises(ValueError):
        tconfig.Config.from_dict({"dsp": {"no_such_knob": 1}})
    # the port-only section, as JSON gives it (lists), round-trips
    h = {"upsample_initial_channel": 256, "upsample_rates": [5, 4, 6],
         "upsample_kernel_sizes": [10, 8, 12],
         "resblock_kernel_sizes": [3, 5],
         "resblock_dilation_sizes": [[1, 2], [2, 6]]}
    t = tconfig.Config.from_dict({**d, "vocoder_mode": "hifigan",
                                  "vocoder_hifigan": h,
                                  "vocoder_hifigan_params_path": "g.npz"})
    back = t.to_dict()
    assert tconfig.Config.from_dict(back) == t and hash(t)
    assert back["vocoder_hifigan"]["resblock_dilation_sizes"] == (
        (1, 2), (2, 6))
    assert _jax_keys(back) == {**d, "vocoder_mode": "hifigan"}
    with pytest.raises(ValueError, match="odd"):
        tconfig.Config.from_dict({"vocoder_hifigan": {
            "resblock_kernel_sizes": [4],
            "resblock_dilation_sizes": [[1]]}})


def test_port_import_loads_no_jax():
    """Importing every module of the port pulls in no jax, flax or JAX
    package module (a fresh interpreter, so the tests' own jax import
    does not count)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import realtime_yukarin_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 19


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_name_no_jax():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("torch_*.py")))
    assert len(files) >= 20
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
