"""The port's TCP server (``runtime/socket_server.py``) and its serve CLI
(``cli/serve.py``) on the CPU — the analogues of tests/test_socket_server.py
and of cli.serve's rows of tests/test_cli.py and test_live_audio.py: one
client's output equal to a single stream with its slot's noise key,
concurrent clients, slot reuse, an abrupt disconnect, a 16 kHz client; the
CLI's wav, --pipelined, --socket and --live modes with ``--device cpu``."""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from realtime_yukarin_tpu_torch.cli import serve as t_serve
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.voice_changer import init_params
from realtime_yukarin_tpu_torch.runtime import live_audio
from realtime_yukarin_tpu_torch.runtime.socket_server import (
    SocketVoiceServer, convert_over_socket)
from realtime_yukarin_tpu_torch.streaming.pipeline import (
    lane_noise_keys, noise_key_from_seed)
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.utils.audio_io import read_wav, write_wav

from conftest import make_test_signal
from test_live_audio import TINY, FakeBackend
from test_socket_server import _DEADLINE_S
from torch_parity import configs, perturbed_params, rel_to_peak


@pytest.fixture(scope="module")
def tiny():
    """The tiny port config (float32) and perturbed weights (every stage
    active)."""
    jc, tc = configs()
    return tc, perturbed_params(jc, tc)[1]


@pytest.fixture(scope="module")
def served(tiny):
    cfg, params = tiny
    with SocketVoiceServer(params, cfg, num_streams=4, device="cpu") as srv:
        yield srv, cfg


def convert_retrying(srv, pcm, deadline_s=_DEADLINE_S):
    """convert_over_socket, retried while the server refuses (full)."""
    deadline = time.time() + deadline_s
    while True:
        try:
            y = convert_over_socket(*srv.address, pcm)
        except OSError:
            y = np.zeros(0, np.float32)
        if len(y) or time.time() > deadline:
            return y
        time.sleep(0.2)


def _single_stream(params, cfg, x, key):
    stream = VoiceChangerStream(params, cfg, noise_key=key, device="cpu")
    stream.add(x)
    return np.concatenate([stream.process(), stream.flush()])


def test_socket_output_equals_a_single_stream(tiny):
    """A fresh server's first client gets slot 0: its output equals a
    VoiceChangerStream with lane 0's key, within 2e-3 of the peak."""
    cfg, params = tiny
    x = make_test_signal("speechlike", 0.55, cfg.dsp.in_rate).astype(
        np.float32)
    with SocketVoiceServer(params, cfg, num_streams=4, seed=5,
                           device="cpu") as srv:
        y = convert_over_socket(*srv.address, x)
        counters = dict(srv.metrics.counters)
    ref = _single_stream(params, cfg, x, lane_noise_keys(5, 4)[0])
    n = min(len(y), len(ref))
    assert n >= len(x) and len(y) % srv.chunk_out_samples == 0
    assert float(np.abs(ref[:n]).max()) > 1e-2
    assert rel_to_peak(y[:n], ref[:n]) < 2e-3
    assert counters.get("output_overruns", 0) == 0
    assert counters.get("ticker_errors", 0) == 0


def test_concurrent_clients(served):
    srv, cfg = served
    sigs = [make_test_signal(k, 0.4, cfg.dsp.in_rate).astype(np.float32)
            for k in ("harmonic", "sweep", "speechlike")]
    outs = [None] * len(sigs)

    def run(i):
        outs[i] = convert_retrying(srv, sigs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(sigs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=_DEADLINE_S + 60)
        assert not t.is_alive()
    for i, (x, y) in enumerate(zip(sigs, outs)):
        n_in = len(x) // srv.chunk_samples
        assert len(y) >= n_in * srv.chunk_out_samples, f"client {i}"
        assert np.isfinite(y).all() and np.abs(y).max() > 1e-4, i


def test_slot_reuse_and_abrupt_disconnect(served):
    """More sequential sessions than slots, then a client that resets
    its connection mid-chunk: slots recycle and the next session is
    clean."""
    srv, cfg = served
    x = make_test_signal("noise", 0.2, cfg.dsp.in_rate).astype(np.float32)
    for _ in range(6):                       # > num_streams = 4
        y = convert_retrying(srv, x)
        assert len(y) > 0 and np.isfinite(y).all()
    assert srv.metrics.counters.get("accepted_connections", 0) >= 6
    deadline = time.time() + _DEADLINE_S
    while True:
        try:
            s = socket.create_connection(srv.address)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         b"\x01\x00\x00\x00\x00\x00\x00\x00")
            s.sendall(np.zeros(srv.chunk_samples // 2, "<f4").tobytes())
            s.close()                        # RST: linger 0
            break
        except OSError:
            assert time.time() < deadline
            time.sleep(0.5)
    x = make_test_signal("harmonic", 0.3, cfg.dsp.in_rate).astype(
        np.float32)
    y = convert_retrying(srv, x)
    assert len(y) >= len(x) // srv.chunk_samples * srv.chunk_out_samples
    assert np.isfinite(y).all() and float(np.abs(y).max()) > 1e-4
    assert srv.metrics.counters.get("ticker_errors", 0) == 0


def test_cross_rate_client(tiny):
    """A 16 kHz client served at 24 kHz out: in_rate PCM on the way in,
    out_rate PCM on the way out."""
    cfg, params = tiny
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=16000))
    with SocketVoiceServer(params, cfg, num_streams=2,
                           device="cpu") as srv:
        assert (srv.chunk_samples, srv.chunk_out_samples) == (1600, 2400)
        x = make_test_signal("harmonic", 0.5, 16000).astype(np.float32)
        y = convert_over_socket(*srv.address, x)
    assert len(y) >= len(x) // 1600 * 2400 and len(y) % 2400 == 0
    assert np.isfinite(y).all() and float(np.abs(y).max()) > 1e-4


# -- cli.serve ----------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    cfg_path = d / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(
        {**TINY, "compute_dtype": "float32", "input_device": "microphone",
         "output_device": "speakers"}))
    wav = d / "in.wav"
    write_wav(str(wav), make_test_signal("speechlike", 0.6, 24000), 24000)
    return str(cfg_path), str(wav)


def test_serve_cli_wav_and_pipelined(files, tmp_path):
    """The synchronous mode equals a VoiceChangerStream at the config's
    seed-0 weights; --pipelined equals the synchronous mode."""
    cfg_path, wav = files
    outs = {}
    for mode, extra in (("sync", []), ("pipelined", ["--pipelined"])):
        out = tmp_path / f"{mode}.wav"
        t_serve.main(["--input_wav", wav, "--output_wav", str(out),
                      "--config_path", cfg_path, "--device", "cpu",
                      *extra])
        outs[mode], rate = read_wav(str(out))
        assert rate == 24000
    cfg = Config.from_yaml(cfg_path)
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed))
    x, _ = read_wav(wav, target_rate=24000)
    x = x[: len(x) // 2400 * 2400]
    ref = _single_stream(params, cfg, x, noise_key_from_seed(0))
    # through the same 16-bit wav round trip as the CLI's output
    write_wav(str(tmp_path / "ref.wav"), ref, 24000)
    ref, _ = read_wav(str(tmp_path / "ref.wav"))
    n = min(len(ref), len(outs["sync"]), len(outs["pipelined"]))
    assert n >= len(x) and np.abs(ref).max() > 1e-2
    np.testing.assert_array_equal(outs["sync"][:n], ref[:n])
    np.testing.assert_array_equal(outs["pipelined"][:n], outs["sync"][:n])


def test_serve_cli_socket_one_client(files):
    cfg_path, wav = files
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    runner = threading.Thread(target=t_serve.main, args=([
        "--socket", str(port), "--host", "127.0.0.1", "--num_streams", "2",
        "--duration", "15", "--config_path", cfg_path,
        "--device", "cpu"],), daemon=True)
    runner.start()
    x, _ = read_wav(wav)
    deadline = time.time() + 120
    while True:
        try:
            y = convert_over_socket("127.0.0.1", port, x)
            break
        except OSError:
            assert time.time() < deadline, "the server never came up"
            time.sleep(0.2)
    runner.join(timeout=60)
    assert not runner.is_alive()
    assert len(y) >= len(x) // 2400 * 2400 and np.isfinite(y).all()
    assert float(np.abs(y).max()) > 1e-3


def test_serve_cli_live_and_list_devices(files, monkeypatch, capsys):
    """--live runs the mic -> speaker loop on the injected backend;
    --list_devices prints the device table."""
    cfg_path, wav = files
    x, _ = read_wav(wav)
    backend = FakeBackend(x[:9600], speed=4.0)
    monkeypatch.setattr(live_audio, "load_backend", lambda name: backend)
    t_serve.main(["--live", "--duration", "1.2", "--config_path", cfg_path,
                  "--device", "cpu"])
    played = np.concatenate(backend.played)
    assert np.isfinite(played).all() and len(played) > 0
    t_serve.main(["--list_devices"])
    out = capsys.readouterr().out
    assert "Fake Duplex" in out and "idx" in out


def test_serve_cli_profile_and_no_fallback(files, tmp_path):
    cfg_path, wav = files
    t_serve.main(["--input_wav", wav, "--output_wav", str(tmp_path / "o.wav"),
                  "--config_path", cfg_path, "--device", "cpu",
                  "--profile_dir", str(tmp_path / "trace")])
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_serve.main(["--input_wav", wav, "--output_wav",
                          str(tmp_path / "o.wav"), "--config_path",
                          cfg_path])
