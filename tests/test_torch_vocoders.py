"""The vocoder-mode registry (``models/vocoders.py`` of the port).

One record per mode holds what differs between the modes; no other module
of the port names a mode.  CPU only and without JAX: an ``ast`` scan of
the package, each record's halo and synth carry, the entry points'
signatures and the CLIs' flag resolution.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import pathlib

import pytest

import realtime_yukarin_tpu_torch
from realtime_yukarin_tpu_torch.config import VOCODER_MODES, Config
from realtime_yukarin_tpu_torch.dsp.synthesis import SynthCarry, WaveCarry
from realtime_yukarin_tpu_torch.models import vocoders
from realtime_yukarin_tpu_torch.parallel.serving import (BatchedServer,
                                                         make_batched_step)
from realtime_yukarin_tpu_torch.pipeline import (offline_convert,
                                                 offline_convert_eager,
                                                 offline_convert_io)
from realtime_yukarin_tpu_torch.runtime.pipelined import PipelinedStream
from realtime_yukarin_tpu_torch.runtime.socket_server import \
    SocketVoiceServer
from realtime_yukarin_tpu_torch.streaming.pipeline import init_stream
from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

PACKAGE = pathlib.Path(realtime_yukarin_tpu_torch.__file__).parent
OWNERS = ("models/vocoders.py", "config.py")


def _mode_name(node) -> bool:
    return isinstance(node, ast.Constant) and node.value in VOCODER_MODES


def mode_literals(package: pathlib.Path) -> list[str]:
    """Where a module of ``package`` other than ``OWNERS`` compares with a
    mode's name (``==``, ``!=``, ``in`` a literal tuple ...) or keys a
    dict by modes (two keys or more that are modes' names: a dict with one
    such key, such as a loss called "wave", is not a per-mode dict)."""
    found = []
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package).as_posix()
        if rel in OWNERS:
            continue
        for node in ast.walk(ast.parse(path.read_text(), rel)):
            if isinstance(node, ast.Compare):
                for side in (node.left, *node.comparators):
                    items = (side.elts if isinstance(
                        side, (ast.Tuple, ast.List, ast.Set)) else (side,))
                    if any(_mode_name(x) for x in items):
                        found.append(f"{rel}:{node.lineno} compares")
            elif isinstance(node, ast.Dict):
                if sum(_mode_name(k) for k in node.keys) >= 2:
                    found.append(f"{rel}:{node.lineno} keys a dict")
    return found


def test_no_module_but_the_registry_names_a_mode():
    assert mode_literals(PACKAGE) == []


def test_the_scan_sees_a_comparison_and_a_per_mode_dict(tmp_path):
    (tmp_path / "m.py").write_text(
        'a = mode == "wave"\nb = {"dsp": 0, "ddsp": 1}\n'
        'c = {"wave": 1, "loss": 2}\nd = mode in ("x", "hifigan")\n')
    assert mode_literals(tmp_path) == ["m.py:1 compares",
                                       "m.py:2 keys a dict",
                                       "m.py:4 compares"]


def test_one_record_per_mode():
    assert tuple(vocoders.VOCODERS) == VOCODER_MODES
    with pytest.raises(ValueError, match="vocoder_mode must be"):
        vocoders.vocoder("melgan")


# each mode's halo section of the config, and the carry type that
# StreamCarry.init gave it before the registry
SECTIONS = {"dsp": None, "ddsp": "vocoder_nn", "wave": "vocoder_wave",
            "hifigan": "vocoder_hifigan", "bigvgan": "vocoder_bigvgan"}
CARRIES = {"dsp": SynthCarry, "ddsp": SynthCarry, "wave": WaveCarry,
           "hifigan": type(None), "bigvgan": type(None)}
GENERATORS = ("hifigan", "bigvgan")     # halo in rows of several frames


@pytest.mark.parametrize("use_sr", [True, False])
@pytest.mark.parametrize("mode", VOCODER_MODES)
def test_a_record_halo_is_its_config_section(mode, use_sr):
    """The halo is the section's receptive field (a generator's in whole
    conditioning rows: two frames a row in the bigvgan mode); the model
    halo adds to it the frames that put D on a row's first frame."""
    cfg = Config()
    voc = vocoders.vocoder(mode)
    section = getattr(cfg, SECTIONS[mode]) if SECTIONS[mode] else None
    ctx = (0 if section is None else section.halo_frames(cfg.dsp.hop)
           if mode in GENERATORS else section.context_frames)
    r = voc.frames_per_row(cfg)
    assert voc.context_frames(cfg) == ctx and ctx % r == 0
    assert r == (2 if mode == "bigvgan" else 1)
    assert voc.reads_envelope == (mode not in GENERATORS)
    sr = cfg.super_resolution.context_frames if (
        use_sr and voc.reads_envelope) else 0
    geo = StreamGeometry.from_config(cfg, use_sr, vocoder_mode=mode)
    base = (cfg.acoustic.context_frames + cfg.dsp.f0_edge_frames + sr + ctx)
    assert 0 <= geo.model_ctx - base < r and geo.delay_frames % r == 0


@pytest.mark.parametrize("mode", VOCODER_MODES)
def test_a_record_synth_carry(mode):
    cfg = Config()
    synth = vocoders.vocoder(mode).init_synth(cfg, "cpu")
    assert type(synth) is CARRIES[mode]
    if synth is not None:
        leaves = dataclasses.asdict(synth)
        assert all(not v.any() for v in _tensors(leaves))
    if mode == "wave":
        assert synth.frac_phase.shape == (cfg.vocoder_wave.phase_fractional,)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


ENTRY_POINTS = (StreamGeometry.from_config, init_stream, VoiceChangerStream,
                PipelinedStream, SocketVoiceServer, BatchedServer,
                make_batched_step, offline_convert, offline_convert_eager,
                offline_convert_io)


@pytest.mark.parametrize("entry", ENTRY_POINTS,
                         ids=lambda e: e.__qualname__)
def test_an_entry_point_takes_the_mode_alone(entry):
    params = inspect.signature(entry).parameters
    assert "use_neural_vocoder" not in params
    assert params["vocoder_mode"].default == "dsp"


def test_an_unknown_mode_is_refused_before_a_step():
    with pytest.raises(ValueError, match="vocoder_mode must be"):
        StreamGeometry.from_config(Config(), vocoder_mode="melgan")
    with pytest.raises(ValueError, match="vocoder_mode must be"):
        make_batched_step(Config(), vocoder_mode="melgan")


@pytest.mark.parametrize("choice,neural,cfg_mode,cfg_neural,want", [
    ("wave", True, "hifigan", True, "wave"),     # --vocoder wins
    ("hifigan", False, "dsp", False, "hifigan"),
    (None, True, "hifigan", False, "ddsp"),      # then --neural_vocoder
    (None, False, "hifigan", False, "hifigan"),  # then the config
    (None, False, "dsp", True, "ddsp"),          # its legacy boolean too
    (None, False, "dsp", False, "dsp"),
])
def test_the_cli_flags_resolve_once(choice, neural, cfg_mode, cfg_neural,
                                    want):
    cfg = Config(vocoder_mode=cfg_mode, use_neural_vocoder=cfg_neural)
    assert vocoders.mode_from_flags(choice, neural, cfg) == want


def test_the_cli_flags_refuse_an_unknown_mode():
    with pytest.raises(ValueError, match="vocoder_mode must be"):
        vocoders.mode_from_flags("melgan", False, Config())
