"""The port's offline convert CLI against the JAX package's: file to file
on a tiny YAML config, both loading the same ``.npz`` weights; the same
sample count, and the same audio within 2e-3 of the peak (the streamed ==
offline tolerance)."""

import sys

import numpy as np
import pytest

from realtime_yukarin_tpu.cli.convert import main as j_main
from realtime_yukarin_tpu_torch.cli.convert import main as t_main
from realtime_yukarin_tpu_torch.utils import audio_io as t_io
from realtime_yukarin_tpu.utils import audio_io as j_io

from conftest import make_test_signal
from torch_parity import ALL_NETS, configs, perturbed_params, rel_to_peak

TINY_YAML = """
acoustic: {hidden: 32, num_blocks: 2}
super_resolution: {hidden: 64, num_blocks: 2}
vocoder_nn: {hidden: 32, num_blocks: 2}
compute_dtype: float32
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(config path, input wav, perturbed weights .npz) for the tiny
    config, whose weights the JAX package's tiny_config() also fits."""
    d = tmp_path_factory.mktemp("cli")
    cfg_path = d / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    jc, tc = configs()
    _, _, flat = perturbed_params(jc, tc, prefixes=ALL_NETS)
    params = d / "params.npz"
    np.savez(params, **flat)
    wav = d / "in.wav"
    fs = jc.dsp.sample_rate
    t_io.write_wav(str(wav), make_test_signal("speechlike", 0.8, fs), fs)
    return str(cfg_path), str(wav), str(params)


@pytest.mark.parametrize("extra", [[], ["--vocoder", "wave", "--no_sr",
                                        "--seed", "3"]],
                         ids=["default", "wave_no_sr_seed3"])
def test_convert_cli_matches_jax(files, tmp_path, extra):
    cfg_path, wav, params = files
    common = ["--input_path", wav, "--config_path", cfg_path,
              "--params_path", params, *extra]
    j_out, t_out = tmp_path / "j.wav", tmp_path / "t.wav"
    j_main(common + ["--output_path", str(j_out)])
    t_main(common + ["--output_path", str(t_out), "--device", "cpu"])
    yj, fj = j_io.read_wav(str(j_out))
    yt, ft = t_io.read_wav(str(t_out))
    x, _ = t_io.read_wav(wav)
    assert ft == fj == 24000
    assert len(yt) == len(yj) and abs(len(yt) - len(x)) < 120
    assert np.isfinite(yt).all() and np.abs(yt).max() > 1e-2
    assert rel_to_peak(yt, yj) < 2e-3


def test_convert_cli_refuses_msgpack(files, tmp_path, monkeypatch):
    """Without the msgpack module the port refuses a .msgpack path and
    names the .npz layout it reads without it."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    cfg_path, wav, _ = files
    (tmp_path / "params.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match=r"\.npz layout"):
        t_main(["--input_path", wav, "--output_path", str(tmp_path / "o.wav"),
                "--config_path", cfg_path, "--params_path",
                str(tmp_path / "params.msgpack"), "--device", "cpu"])


def test_audio_io_matches_jax(tmp_path):
    """The port's copy of audio_io reads and writes what the JAX
    package's does, resampling included."""
    x = make_test_signal("sweep", 0.2, 16000).astype(np.float32)
    t_io.write_wav(str(tmp_path / "a.wav"), x, 16000)
    j_io.write_wav(str(tmp_path / "b.wav"), x, 16000)
    assert ((tmp_path / "a.wav").read_bytes()
            == (tmp_path / "b.wav").read_bytes())
    for rate in (None, 24000):
        yt, rt = t_io.read_wav(str(tmp_path / "a.wav"), target_rate=rate)
        yj, rj = j_io.read_wav(str(tmp_path / "a.wav"), target_rate=rate)
        assert rt == rj
        np.testing.assert_array_equal(yt, yj)
