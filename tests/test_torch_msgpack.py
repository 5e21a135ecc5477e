"""The port reads the JAX package's default flax ``.msgpack`` weights
without flax: a tree written by the JAX package's ``save_params(params,
"x.msgpack")`` loads equal, leaf for leaf, to the same tree's ``.npz``,
through ``load_params_npz``, ``load_all_params`` (full tree and per-stage
subtree files) and ``cli.convert``."""

import dataclasses

import numpy as np
import pytest
import torch

from realtime_yukarin_tpu.models import voice_changer as j_vc
from realtime_yukarin_tpu_torch.cli.convert import main as t_convert
from realtime_yukarin_tpu_torch.models import voice_changer as t_vc
from realtime_yukarin_tpu_torch.utils import audio_io

from conftest import make_test_signal
from test_torch_cli import TINY_YAML
from torch_parity import ALL_NETS, configs, perturbed_params

STAGES = ("stage1", "stage2", "vocoder", "vocoder_wave")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The perturbed JAX tree saved by the JAX package, whole and per
    stage, as .msgpack and as .npz."""
    d = tmp_path_factory.mktemp("params")
    jc, tc = configs()
    jp, _, _ = perturbed_params(jc, tc, prefixes=ALL_NETS)
    for ext in ("msgpack", "npz"):
        j_vc.save_params(jp, str(d / f"all.{ext}"))
        for stage in STAGES:
            j_vc.save_params(jp[stage], str(d / f"{stage}.{ext}"))
    return d, tc


def _same(a: dict, b: dict):
    fa, fb = t_vc.params_to_jax(a), t_vc.params_to_jax(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_full_tree_msgpack_equals_npz(saved):
    d, tc = saved
    _same(t_vc.load_params_npz(str(d / "all.msgpack"), tc),
          t_vc.load_params_npz(str(d / "all.npz"), tc))
    flat = t_vc._read_params(str(d / "all.msgpack"))
    assert all(v.dtype == np.float32 for v in flat.values())


@pytest.mark.parametrize("route", ["params_path", "stage_paths"])
def test_load_all_params_msgpack_equals_npz(saved, route):
    d, tc = saved
    init = t_vc.init_params(tc, torch.Generator().manual_seed(7))
    loaded = {}
    for ext in ("msgpack", "npz"):
        if route == "params_path":
            over = {"params_path": str(d / f"all.{ext}")}
        else:
            over = {f"{s}_params_path":
                    str(d / f"{s}.{ext}") for s in STAGES}
        loaded[ext] = t_vc.load_all_params(
            init, dataclasses.replace(tc, **over))
    _same(loaded["msgpack"], loaded["npz"])
    # the loaded tree is the saved one, not the init
    want = t_vc.params_to_jax(t_vc.load_params_npz(str(d / "all.npz"), tc))
    got = t_vc.params_to_jax(loaded["msgpack"])
    for k in got:
        if k.startswith(tuple(f"{s}/" for s in STAGES)):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_cli_reads_msgpack(saved, tmp_path):
    d, _ = saved
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    wav = tmp_path / "in.wav"
    audio_io.write_wav(str(wav), make_test_signal("speechlike", 0.5, 24000),
                       24000)
    outs = {}
    for ext in ("msgpack", "npz"):
        out = tmp_path / f"{ext}.wav"
        t_convert(["--input_path", str(wav), "--output_path", str(out),
                   "--config_path", str(cfg_path), "--params_path",
                   str(d / f"all.{ext}"), "--device", "cpu"])
        outs[ext], _ = audio_io.read_wav(str(out))
    assert np.abs(outs["npz"]).max() > 1e-2
    np.testing.assert_array_equal(outs["msgpack"], outs["npz"])
