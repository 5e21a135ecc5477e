"""The port's host runtime on the CPU: the native ring buffer and WAV I/O
(its own copy of the C++ source, built with g++ into ``_build/``), the
serving metrics and the torch.profiler hooks, the dispatch-ahead
PipelinedStream (equal to the synchronous stream, silence on underrun,
depth 1 and 3), the live mic -> speaker loop on a fake audio backend and
a short soak — the CPU analogues of tests/test_runtime.py,
test_pipelined.py, test_live_audio.py and test_soak.py."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from realtime_yukarin_tpu_torch import runtime as rt
from realtime_yukarin_tpu_torch.models.voice_changer import init_params
from realtime_yukarin_tpu_torch.runtime import live_audio
from realtime_yukarin_tpu_torch.runtime.pipelined import PipelinedStream
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.utils import audio_io, profiling
from realtime_yukarin_tpu_torch.utils.metrics import (LatencyHistogram,
                                                      ServingMetrics)

from conftest import make_test_signal
from test_live_audio import DEVICES, FakeBackend
from torch_parity import configs


@pytest.fixture(scope="module")
def tiny():
    """The tiny port config (float32) and freshly initialised weights."""
    _, tc = configs()
    return tc, init_params(tc, torch.Generator().manual_seed(0))


# -- native ring buffer and WAV I/O ------------------------------------------

def test_native_library_is_built_into_the_build_dir_with_portable_flags():
    path = rt.build()
    assert path.parent == rt.BUILD_DIR and path.exists()
    assert "-march=native" not in rt.GXX_FLAGS
    assert path == rt.library_path() and path.name.startswith(
        "native_runtime-")


def test_ring_buffer_roundtrip_and_wraparound():
    rb = rt.RingBuffer(1000)
    assert rb.capacity == 1024
    x = np.arange(300, dtype=np.float32)
    assert rb.push(x) == 300 and rb.available == 300
    np.testing.assert_array_equal(rb.pop(300), x)
    assert rb.available == 0
    rb = rt.RingBuffer(256)
    for it in range(50):                 # forces many wraps
        x = np.full(100, it, np.float32)
        assert rb.push(x) == 100
        np.testing.assert_array_equal(rb.pop(100), x)


def test_ring_buffer_overrun_and_silence_on_underrun():
    rb = rt.RingBuffer(128)
    assert rb.push(np.zeros(200, np.float32)) == 128
    assert rb.overruns == 1
    rb = rt.RingBuffer(256)
    rb.push(np.ones(50, np.float32))
    out, ok = rb.pop_chunk_or_silence(100)
    assert not ok and rb.underruns == 1
    np.testing.assert_array_equal(out, np.zeros(100, np.float32))
    np.testing.assert_array_equal(rb.pop(50), np.ones(50, np.float32))


def test_ring_buffer_threaded_spsc():
    """Producer and consumer on separate threads: all data arrives in
    order."""
    rb = rt.RingBuffer(1 << 12)
    total = 200_000
    src = np.random.default_rng(0).standard_normal(total).astype(np.float32)
    got = []

    def producer():
        pos = 0
        while pos < total:
            pos += rb.push(src[pos: pos + 997])

    def consumer():
        count = 0
        while count < total:
            y = rb.pop(1024)
            if len(y):
                got.append(y)
                count += len(y)

    threads = [threading.Thread(target=producer),
               threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), src)
    assert rb.underruns == 0


def test_native_wav_roundtrip_and_python_io(tmp_path):
    fs = 24000
    x = (0.5 * np.sin(2 * np.pi * 220 * np.arange(fs) / fs)
         ).astype(np.float32)
    path = str(tmp_path / "t.wav")
    rt.write_wav_native(path, x, fs)
    y, rate = rt.read_wav_native(path)
    assert rate == fs and len(y) == len(x)
    np.testing.assert_allclose(y, x, atol=1.0 / 32000)
    x = np.random.default_rng(1).uniform(-0.9, 0.9, fs // 2).astype(
        np.float32)
    audio_io.write_wav(str(tmp_path / "a.wav"), x, fs)
    y_native, r1 = rt.read_wav_native(str(tmp_path / "a.wav"))
    y_py, r2 = audio_io.read_wav(str(tmp_path / "a.wav"))
    assert r1 == r2 == fs
    np.testing.assert_allclose(y_native, y_py, atol=1e-6)


def test_native_source_is_the_jax_packages_ring_and_wav_code():
    """The port's copy differs from the JAX package's source in comments
    only."""
    import pathlib

    def code(path):
        lines = []
        for line in pathlib.Path(path).read_text().splitlines():
            line = line.split("//")[0].rstrip()
            if line:
                lines.append(line)
        return lines
    root = pathlib.Path(__file__).resolve().parent.parent
    assert (code(root / "realtime_yukarin_tpu_torch/runtime/"
                 "native_runtime.cpp")
            == code(root / "realtime_yukarin_tpu/runtime/"
                    "native_runtime.cpp"))


# -- metrics and profiling ----------------------------------------------------

def test_metrics_histogram_and_counters():
    h = LatencyHistogram(capacity=8)
    assert np.isnan(h.percentiles()["p50"])
    for ms in range(1, 11):                  # wraps the 8-slot buffer
        h.record(float(ms))
    assert h.count == 10
    s = h.summary()
    assert s["count"] == 10 and s["max"] == 10.0
    m = ServingMetrics()
    m.incr("a")
    m.incr("a", 2)
    m.chunk_latency.record(1.5)
    d = json.loads(m.to_json())
    assert d["counters"] == {"a": 3}
    assert d["chunk_latency_ms"]["count"] == 1


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):              # no-op
        pass
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("host.test.step"), profiling.span("host.test.work"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"host.test.step", "host.test.work"} <= names


# -- pipelined stream ---------------------------------------------------------

def _pipelined(params, cfg, x, depth):
    with PipelinedStream(params, cfg, seed=0, depth=depth,
                         device="cpu") as pipe:
        pipe.push_input(x)
        pipe.flush()
        got = pipe.pop_output(pipe.output_available())
    return got, pipe


def test_pipelined_equals_synchronous(tiny):
    cfg, params = tiny
    x = make_test_signal("speechlike", 0.8, cfg.dsp.sample_rate).astype(
        np.float32)
    sync = VoiceChangerStream(params, cfg, seed=0, device="cpu")
    S = sync.chunk_samples
    x = x[: len(x) // S * S]
    sync.add(x)
    ref = np.concatenate([sync.process(), sync.flush()])
    got, pipe = _pipelined(params, cfg, x, 2)
    n = min(len(ref), len(got))
    assert n >= len(x)
    np.testing.assert_array_equal(got[:n], ref[:n])
    assert pipe.metrics.chunk_latency.count >= len(x) // S
    assert pipe.metrics.counters.get("output_underruns", 0) == 0


def test_pipelined_silence_on_underrun(tiny):
    cfg, params = tiny
    with PipelinedStream(params, cfg, seed=0, device="cpu") as pipe:
        np.testing.assert_array_equal(pipe.pop_output(256),
                                      np.zeros(256, np.float32))
        assert pipe.metrics.counters["output_underruns"] == 1


def test_pipelined_depth_one_and_three(tiny):
    cfg, params = tiny
    x = make_test_signal("harmonic", 0.4, cfg.dsp.sample_rate).astype(
        np.float32)
    outs = [_pipelined(params, cfg, x, depth)[0] for depth in (1, 3)]
    n = min(map(len, outs))
    assert n >= len(x) // 2400 * 2400
    np.testing.assert_array_equal(outs[0][:n], outs[1][:n])


class _LateInput:
    """The input ring, where the producer's pushes land right after the
    dispatch thread has read ``available`` once more (``late``)."""

    def __init__(self, ring):
        self._ring, self.late = ring, None

    @property
    def available(self):
        n = self._ring.available
        late, self.late = self.late, None
        if late is not None:
            late()
        return n

    def __getattr__(self, name):
        return getattr(self._ring, name)


def test_pipelined_flush_after_a_stale_input_check(tiny):
    """A flush whose input and flag land between the dispatch thread's
    check of the input ring and its check of the flag still converts every
    chunk (the thread reads the ring again before it calls the stream
    drained)."""
    cfg, params = tiny
    x = make_test_signal("harmonic", 0.4, cfg.dsp.sample_rate).astype(
        np.float32)
    with PipelinedStream(params, cfg, seed=0, device="cpu") as pipe:
        ring = pipe._in_rb = _LateInput(pipe._in_rb)
        S = pipe.chunk_samples
        n_lat = -(-pipe.latency_samples // pipe.chunk_out_samples)

        def producer():
            ring.push(x)
            ring.push(np.zeros((n_lat + 1) * S, np.float32))
            pipe._flushing.set()

        ring.late = producer
        assert pipe._drained.wait(60)
        assert pipe.output_available() >= len(x) // S * S


def test_pipelined_defaults_to_cuda_without_fallback(tiny):
    cfg, params = tiny
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipelinedStream(params, cfg)


# -- live audio on a fake backend ---------------------------------------------

def test_live_resolve_device_and_table():
    rd = live_audio.resolve_device
    assert rd(DEVICES, None, "input") is None
    assert rd(DEVICES, "microphone", "input") == 0
    assert rd(DEVICES, "hdmi", "output") == 1
    assert rd(DEVICES, "2", "input") == 2
    with pytest.raises(ValueError):
        rd(DEVICES, "speakers", "input")
    with pytest.raises(ValueError):
        rd(DEVICES, 0, "output")
    assert "Fake Duplex" in live_audio.format_device_table(DEVICES)


def test_live_session_end_to_end(tiny):
    """Mic audio goes in through callbacks; converted audio comes back
    out of the speaker callback."""
    cfg, params = tiny
    audio = make_test_signal("speechlike", 0.6, cfg.dsp.in_rate).astype(
        np.float32)
    backend = FakeBackend(audio, speed=4.0)
    with PipelinedStream(params, cfg, depth=2, device="cpu") as stream:
        session = live_audio.LiveSession(stream, cfg, backend,
                                         input_device="microphone",
                                         output_device="speakers")
        stop = threading.Event()
        n_chunks = len(audio) // stream.chunk_samples

        def stop_after_drain():
            # poll until every captured chunk was converted and played
            # (a loaded host runs the CPU step slowly: no wall-clock guess)
            deadline = time.time() + 120
            backend.input_done.wait(timeout=120)
            while (stream.metrics.chunk_latency.count < n_chunks
                   or stream.output_available() >= 480) \
                    and time.time() < deadline:
                time.sleep(0.05)
            time.sleep(0.2)
            stop.set()

        threading.Thread(target=stop_after_drain, daemon=True).start()
        session.run(stop=stop)
    played = np.concatenate(backend.played)
    assert np.isfinite(played).all()
    assert float(np.abs(played).max()) > 0.01
    assert float(np.square(played).sum()) > 0.1
    assert stream.metrics.chunk_latency.count >= 3


# -- soak ---------------------------------------------------------------------

def test_soak_pipelined_stream(tiny):
    """300 chunks (30 simulated seconds) through PipelinedStream: every
    sample finite, nothing dropped, output power stable between the first
    and the last 10 s."""
    cfg, params = tiny
    n_chunks = 300
    with PipelinedStream(params, cfg, ring_seconds=2.0,
                         device="cpu") as ps:
        S, So = ps.chunk_samples, ps.chunk_out_samples
        fs = cfg.dsp.in_rate
        rng = np.random.default_rng(0)
        got, pushed, phase = [], 0, 0.0
        for _ in range(n_chunks):
            ph = phase + 2 * np.pi * 155.0 * np.arange(1, S + 1) / fs
            x = (0.4 * np.sin(ph) + 0.1 * np.sin(2 * ph)
                 + 0.01 * rng.standard_normal(S)).astype(np.float32)
            phase = float(ph[-1] % (2 * np.pi))
            while len(x):                    # lossless feed
                n = ps.push_input(x)
                pushed += n
                x = x[n:]
                if len(x):
                    time.sleep(0.002)
            if ps.output_available():
                got.append(ps.pop_output(ps.output_available()))
        deadline = time.time() + 120
        while (sum(map(len, got)) < n_chunks * So
               and time.time() < deadline):
            if ps.output_available():
                got.append(ps.pop_output(ps.output_available()))
            else:
                time.sleep(0.005)
        ps.flush()
        if ps.output_available():
            got.append(ps.pop_output(ps.output_available()))
        counters = ps.metrics.counters
    y = np.concatenate(got)
    assert pushed == n_chunks * S and len(y) >= n_chunks * So
    assert np.isfinite(y).all()
    assert counters.get("flush_timeouts", 0) == 0
    assert counters.get("output_underruns", 0) == 0
    ten_s = 100 * So
    rms_first = float(np.sqrt(np.mean(y[So * 10: ten_s] ** 2)))
    rms_last = float(np.sqrt(np.mean(y[n_chunks * So - ten_s:
                                       n_chunks * So] ** 2)))
    assert 0.01 < rms_first < 2.0 and 0.01 < rms_last < 2.0
    assert abs(rms_last - rms_first) < 0.25 * max(rms_first, rms_last)
    assert float(np.abs(y).max()) < 4.0
