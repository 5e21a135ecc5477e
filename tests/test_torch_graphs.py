"""The captured-program layer (``streaming/program.py``) on the CPU, where a
program runs its body eagerly over the same static buffers that a CUDA
graph captures on the card: the stream's program against the
``streaming_step`` loop bit for bit and against the JAX package's stream,
the batched program against ``make_batched_step``'s loop with a paused and
a reset lane (``chip_smoke.py`` phase 19's helper, run here on the CPU),
outputs that stay the caller's across the next step, the offline program
cache, and the warm-up's snapshot and restore.  Tiny model config,
float32."""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from realtime_yukarin_tpu.streaming.stream import VoiceChangerStream as JStream
from realtime_yukarin_tpu_torch import pipeline as t_offline
from realtime_yukarin_tpu_torch.streaming import pipeline as t_pipe
from realtime_yukarin_tpu_torch.streaming.state import tree_leaves
from realtime_yukarin_tpu_torch.streaming.stream import (
    VoiceChangerStream as TStream)

from conftest import make_test_signal
from test_torch_streaming import _noise_key, _rates
from torch_parity import ALL_NETS, configs, perturbed_params, rel_to_peak

CHUNKS = 6
# (vocoder mode, client rate in and out or None, port vs JAX tolerance:
# tests/test_torch_streaming.py's).  The stream IS its program, so
# tests/test_torch_streaming*.py hold the program to JAX's stream in every
# mode over 1 s; here JAX's compile is paid for the main path only.
CASES = {"dsp": ("dsp", None, 2e-3), "ddsp": ("ddsp", None, None),
         "wave": ("wave", None, None), "48k": ("dsp", 48000, None)}


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    jp, tp, _ = perturbed_params(jc, tc, prefixes=ALL_NETS)
    return jc, tc, jp, tp


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("case", CASES)
def test_stream_program_equals_the_step_loop_and_jax(setup, case):
    """Six chunks through the stream's program: each output and the carry
    equal the ``streaming_step`` loop's from the same init carry bit for
    bit; in dsp the outputs match the JAX package's stream (identical
    voicing)."""
    jc, tc, jp, tp = setup
    mode, rate, tol = CASES[case]
    if rate is not None:
        jc, tc = _rates(jc, rate, rate), _rates(tc, rate, rate)
    key, noise_key = _noise_key()
    ts = TStream(tp, tc, noise_key=noise_key, vocoder_mode=mode,
                 device="cpu")
    carry, _ = t_pipe.init_stream(tp, tc, vocoder_mode=mode, device="cpu")
    key_t = torch.tensor(noise_key, dtype=torch.int64)
    S = ts.chunk_samples
    fs = tc.dsp.in_rate
    x = make_test_signal("formant", CHUNKS * S / fs + 0.01, fs)[
        : CHUNKS * S].astype(np.float32)
    ys, voicing = [], []
    for k in range(CHUNKS):
        chunk = torch.from_numpy(x[k * S: (k + 1) * S])
        y = ts.step_device(chunk)
        with torch.no_grad():
            y_ref, carry = t_pipe.streaming_step(tp, carry, chunk, key_t, tc,
                                                 vocoder_mode=mode)
        assert torch.equal(y, y_ref), k
        assert _leaves_equal(ts._carry, carry), k
        ys.append(y.numpy())
        voicing.append(ts.final_f0() > 0)
    if tol is None:
        return
    js = JStream(jp, jc, key=key, vocoder_mode=mode)
    yj, vj = [], []
    for k in range(CHUNKS):
        js.add(x[k * S: (k + 1) * S])
        yj.append(js.process())
        vj.append(np.asarray(js._carry.f0_cache[-20:]) > 0)
    np.testing.assert_array_equal(np.stack(voicing), np.stack(vj))
    assert rel_to_peak(np.concatenate(ys), np.concatenate(yj)) < tol


def test_batched_program_equals_make_batched_step(setup):
    """BatchedServer's program at 8 lanes over phase 12's schedule (lane 5
    paused for steps 8-11, lane 7 reset at step 12) against
    ``make_batched_step``'s step from the same carries, bit for bit; an
    output of ``step_device`` held across the next step is unchanged."""
    _, tc, _, tp = setup
    r = chip_smoke.batched_replay_vs_eager(
        tp, tc, 8, chip_smoke.RESET_STEP + 2, "cpu")
    assert r["mismatched"] == []
    assert r["held"]
    assert not r["program"].captured


def test_stream_and_offline_outputs_stay_the_callers(setup):
    """The stream's and offline_convert's outputs keep their values across
    the next call: each is the caller's, not a static buffer."""
    _, tc, _, tp = setup
    ts = TStream(tp, tc, device="cpu")
    S = ts.chunk_samples
    x = make_test_signal("formant", 2 * S / tc.dsp.sample_rate + 0.01,
                         tc.dsp.sample_rate).astype(np.float32)
    y0 = ts.step_device(torch.from_numpy(x[:S]))
    kept = y0.clone()
    ts.step_device(torch.from_numpy(x[S: 2 * S]))
    assert torch.equal(y0, kept)
    F = 2 * S // tc.dsp.hop
    t_offline.offline_convert(tp, x[: 2 * S], (0, 1, 1), tc, F,
                              device="cpu")     # the first call: eager
    o0 = t_offline.offline_convert(tp, x[: 2 * S], (0, 1, 1), tc, F,
                                   device="cpu")
    kept = o0.clone()
    t_offline.offline_convert(tp, 0.5 * x[: 2 * S], (0, 1, 1), tc, F,
                              device="cpu")
    assert torch.equal(o0, kept)


def test_offline_program_cache(setup, monkeypatch):
    """A length's first call runs the eager body and captures nothing, its
    second builds the program; every call equals the eager body bit for
    bit, a repeated call reuses its program, and beyond the bound the
    least recently used length goes."""
    _, tc, _, tp = setup
    monkeypatch.setattr(t_offline, "_programs", collections.OrderedDict())
    monkeypatch.setattr(t_offline, "PROGRAM_CACHE_SIZE", 3)
    hop = tc.dsp.hop
    x = make_test_signal("formant", 0.3, tc.dsp.sample_rate).astype(
        np.float32)

    def call(F, mode, seed=0):
        key = t_pipe.noise_key_from_seed(seed)
        wave = x[: F * hop]
        y = t_offline.offline_convert(tp, wave, key, tc, F,
                                      vocoder_mode=mode, device="cpu")
        ref = t_offline.offline_convert_eager(tp, wave, key, tc, F,
                                              vocoder_mode=mode,
                                              device="cpu")
        assert torch.equal(y, ref), (F, mode, seed)

    def names():
        return [p.name for p in t_offline.cached_programs()]

    call(40, "dsp")
    assert names() == []             # a conversion made once: no program
    call(40, "dsp", seed=3)
    call(50, "dsp")
    call(50, "dsp")
    call(40, "ddsp")
    call(40, "ddsp")
    assert names() == ["offline 40 frames (dsp)", "offline 50 frames (dsp)",
                       "offline 40 frames (ddsp)"]
    first = t_offline.cached_programs()[0]
    call(40, "dsp", seed=5)          # a new key, the same program
    assert t_offline.cached_programs()[-1] is first
    call(60, "dsp")                  # the bound: 50 frames (dsp) goes
    assert names() == ["offline 40 frames (ddsp)", "offline 40 frames (dsp)"]
    call(60, "dsp")
    assert names()[-1] == "offline 60 frames (dsp)"
    assert len(t_offline._programs) == 3


def test_warm_up_puts_the_carry_back(setup):
    """The warm-up runs the body once on the real carry and
    then restores it from its snapshot: frame_pos and every leaf where
    they were, and the next step equals a fresh stream's first."""
    _, tc, _, tp = setup
    ts = TStream(tp, tc, device="cpu")
    fresh = TStream(tp, tc, device="cpu")
    ts._chunk.copy_(torch.from_numpy(make_test_signal(
        "formant", 0.2, tc.dsp.sample_rate)[: ts.chunk_samples]))
    before = [t.clone() for t in tree_leaves(ts._carry)]
    frame_pos = int(ts._carry.frame_pos)
    calls = []
    body = ts.program._body
    ts.program._body = lambda: calls.append(1) or body()
    ts.program.warm_up()
    assert len(calls) == 1
    assert int(ts._carry.frame_pos) == frame_pos == -ts._geo.delay_frames
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(ts._carry)))
    chunk = torch.from_numpy(np.zeros(ts.chunk_samples, np.float32))
    assert torch.equal(ts.step_device(chunk), fresh.step_device(chunk))
    assert _leaves_equal(ts._carry, fresh._carry)


def test_batched_server_reset_is_in_place(setup):
    """reset_stream writes the init carry into lane i of the static
    carries (no rebinding, the other lanes untouched)."""
    _, tc, _, tp = setup
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    srv = BatchedServer(tp, tc, num_streams=3, device="cpu")
    x = make_test_signal("formant", 0.2, tc.dsp.sample_rate).astype(
        np.float32)[: srv.chunk_samples]
    srv.step(np.stack([x, x, x]))
    leaves = tree_leaves(srv._carries)
    lane0 = [t[0].clone() for t in leaves]
    srv.reset_stream(1)
    assert all(a is b for a, b in zip(leaves, tree_leaves(srv._carries)))
    assert all(torch.equal(t[1], i)
               for t, i in zip(leaves, tree_leaves(srv._init_carry)))
    assert all(torch.equal(t[0], a) for t, a in zip(leaves, lane0))
    assert srv.program.summary().endswith("(CUDA graphs need a GPU)")


def test_tree_copy_refuses_a_partly_overlapping_source():
    """The in-place carry update never reads a view that partly overlaps
    what it writes (``copy_`` raises on it)."""
    from realtime_yukarin_tpu_torch.streaming.state import tree_copy_
    t = torch.arange(6.0)
    with pytest.raises(RuntimeError):
        tree_copy_((t[:4],), (t[2:],))
    a = torch.arange(4.0)
    tree_copy_((a,), (a,))                # a leaf onto itself: a no-op
    assert torch.equal(a, torch.arange(4.0))
