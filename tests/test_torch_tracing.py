"""The port's own tracing (``utils/profiling.py``) on the CPU: ``span`` is a
shared null context unless a profiler records; the batched server, the
training program, the corpus sampler and the socket ticker emit their
``host.*`` spans in order under ``torch.profiler``; a batched step and a
single stream mark the 9 serving stages and a training step the 4
training stages, with the marker's launcher replaced by a recorder (on
the CPU ``mark`` launches nothing); the ticker counts paused lanes and
resets.  Tiny models (``torch_parity.training_configs``), float32."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from realtime_yukarin_tpu_torch.models.voice_changer import init_params
from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
from realtime_yukarin_tpu_torch.runtime.socket_server import (
    SocketVoiceServer, convert_over_socket)
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.training import train_step as ts
from realtime_yukarin_tpu_torch.training.data import make_batch
from realtime_yukarin_tpu_torch.training.dataset import CorpusDataset
from realtime_yukarin_tpu_torch.utils import profiling

from conftest import make_test_signal
from torch_parity import training_configs

SERVE_MARKS = list(profiling.SERVE_STAGES) + ["end"]
TRAIN_MARKS = list(profiling.TRAIN_STAGES) + ["end"]


@pytest.fixture(scope="module")
def tiny():
    """The tiny port config (float32) and fresh weights of every stage."""
    _, tc = training_configs()
    return tc, init_params(tc, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def batch(tiny):
    return make_batch(tiny[0], 2, seconds=0.1, seed=0, device="cpu")


@pytest.fixture
def marks(monkeypatch):
    """The stages ``profiling.mark`` launches, in order, on any device."""
    seen = []
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda stage, like: seen.append(stage))
    return seen


def _host_spans(prof) -> list[str]:
    events = sorted((e for e in prof.events() if e.name.startswith("host.")),
                    key=lambda e: e.time_range.start)
    return [e.name for e in events]


def _chunks(server, seed=0):
    rng = np.random.default_rng(seed)
    return 0.1 * rng.standard_normal(
        (server.num_streams, server.chunk_samples)).astype(np.float32)


# -- span and mark ------------------------------------------------------------

def test_span_is_a_shared_null_context_without_a_profiler(monkeypatch):
    calls = []

    def spy(name):
        calls.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    first, second = profiling.span("host.a.b"), profiling.span("host.c.d")
    assert first is second is profiling._OFF
    with first:
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("host.a.b"):
            pass
    assert calls == ["host.a.b"]


def test_mark_launches_nothing_on_the_cpu_and_refuses_an_unknown_stage():
    cuda.reset_counts()
    for stage in profiling.STAGES:
        profiling.mark(stage, torch.zeros(1))     # no nvcc here: no build
    assert cuda.STAGE_MARK.launches == 0
    with pytest.raises(KeyError, match="stage"):
        profiling.mark("decode", torch.zeros(1))
    assert profiling.STAGES.index("end") == len(profiling.STAGES) - 1


def test_the_marker_source_names_every_stage_at_its_index():
    src = (cuda.CSRC_DIR / "stage_mark.cu").read_text()
    for i, stage in enumerate(profiling.STAGES):
        kernel = "stage_end" if stage == "end" else f"stage_begin_{stage}"
        assert f"__global__ void {kernel}()" in src
        assert f"case {i}: {kernel}<<<1, 1, 0, s>>>();" in src


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("mode,use_sr", [("dsp", True), ("dsp", False),
                                         ("ddsp", True), ("wave", True)])
def test_a_batched_step_marks_the_nine_serving_stages(tiny, marks, mode,
                                                      use_sr):
    cfg, params = tiny
    server = BatchedServer(params, cfg, num_streams=2, use_sr=use_sr,
                           vocoder_mode=mode, device="cpu")
    marks.clear()
    server.step(_chunks(server), live=[True, False], reset=[False, True])
    assert marks == SERVE_MARKS


def test_a_single_stream_marks_the_nine_serving_stages(tiny, marks):
    cfg, params = tiny
    stream = VoiceChangerStream(params, cfg, device="cpu")
    marks.clear()
    stream.step_device(torch.zeros(stream.chunk_samples))
    assert marks == SERVE_MARKS


def test_a_batched_step_emits_its_host_spans_in_order(tiny):
    cfg, params = tiny
    server = BatchedServer(params, cfg, num_streams=2, device="cpu")
    chunks = _chunks(server)
    server.step(chunks)                   # nothing recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.step(chunks)
    assert _host_spans(prof) == ["host.serve.copy_in", "host.program.call",
                                 "host.serve.copy_out"]


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("objective", ["joint", "gan"])
def test_a_training_step_marks_the_four_training_stages(tiny, batch, marks,
                                                        objective):
    cfg, params = tiny
    if objective == "joint":
        state, step = (ts.init_train_state(params, "cpu"),
                       ts.make_train_step(cfg))
    else:
        from realtime_yukarin_tpu_torch.models.discriminator import (
            init_discriminator)
        disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                                  torch.Generator().manual_seed(1))
        state, step = (ts.init_gan_train_state(params, disc, "cpu"),
                       ts.make_gan_train_step(cfg))
    marks.clear()
    step(state, batch)
    assert marks == TRAIN_MARKS


def _corpus(tmp_path, batch) -> str:
    """Two 'prepared pairs' cut from ``batch``'s rows: the arrays
    ``CorpusDataset`` crops."""
    for i in range(2):
        np.savez(tmp_path / f"pair{i}.npz", **{
            f: getattr(batch, f)[i].numpy()
            for f in ("f0_src", "mc_src", "ap_src", "f0_tgt", "mc_tgt",
                      "env_tgt", "f0_voc", "mc_voc", "ap_voc", "env_voc",
                      "wave_voc")})
    return str(tmp_path)


def test_sampling_and_a_training_step_emit_their_host_spans(tiny, batch,
                                                            tmp_path):
    cfg, params = tiny
    ds = CorpusDataset(_corpus(tmp_path, batch), cfg, crop_frames=10,
                       seed=0, device="cpu")
    state, step = ts.init_train_state(params, "cpu"), ts.make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b = ds.sample_batch(2)
        step(state, b)
    assert _host_spans(prof) == ["host.data.draw", "host.data.copy_in",
                                 "host.train.copy_in", "host.program.call"]


# -- the socket ticker --------------------------------------------------------

def test_the_ticker_spans_and_lane_counters_in_a_serve_trace(tiny, tmp_path):
    """A client served under ``profiling.trace``, as ``cli.serve
    --profile_dir`` runs it: the ticker thread's spans are in the trace,
    and its join is counted as one reset."""
    cfg, params = tiny
    x = make_test_signal("speechlike", 0.3, cfg.dsp.in_rate).astype(
        np.float32)
    with profiling.trace(str(tmp_path / "tr")):
        with SocketVoiceServer(params, cfg, num_streams=2,
                               device="cpu") as srv:
            y = convert_over_socket(*srv.address, x)
            counters = dict(srv.metrics.counters)
    assert len(y) >= len(x)
    assert counters["lane_resets"] == counters["accepted_connections"] == 1
    assert counters["lane_ticks_paused"] >= 0
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"host.tick.scan", "host.tick.step", "host.tick.push",
            "host.serve.copy_in", "host.program.call",
            "host.serve.copy_out"} <= names
