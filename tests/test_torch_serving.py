"""The port's batched N-stream serving (``parallel/serving.py``) against the
JAX package's BatchedServer and against its own single streams: lane
noise keys equal to ``jax.random.fold_in``'s, a batched lane equal to the
JAX server's lane and to a port VoiceChangerStream with that lane's key
(2e-3 of the peak, identical voicing), the live mask (a paused lane's
carry bit for bit, zero output), resets by ``reset_stream`` and by the
reset mask, ``num_streams`` taken as given; and the resample matrices
built when a stream or server is made.  Tiny model config, float32."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_yukarin_tpu.parallel.mesh import make_mesh
from realtime_yukarin_tpu.parallel.serving import BatchedServer as JServer
from realtime_yukarin_tpu_torch.dsp import resample as t_rs
from realtime_yukarin_tpu_torch.ops import dft
from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
from realtime_yukarin_tpu_torch.streaming import pipeline as t_pipe
from realtime_yukarin_tpu_torch.streaming.state import (noise_bins,
                                                        tree_leaves)
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

from conftest import make_test_signal
from torch_parity import configs, perturbed_params, rel_to_peak

SEED = 3


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    jp, tp, _ = perturbed_params(jc, tc)
    return jc, tc, jp, tp


def _signal(kind, n_chunks, S, fs=24000, seed=0):
    x = make_test_signal(kind, n_chunks * S / fs + 0.01, fs, seed)
    return x[: n_chunks * S].astype(np.float32)


@pytest.mark.parametrize("seed,i", [(0, 0), (0, 5), (SEED, 2), (SEED, 63),
                                    (2 ** 31 + 7, 1), (2 ** 32 - 1, 17)])
def test_lane_noise_keys_match_jax_fold_in(seed, i):
    bits = np.asarray(jax.random.bits(
        jax.random.fold_in(jax.random.key(seed), i), (3,), jnp.uint32))
    assert (t_pipe.lane_noise_keys(seed, i + 1)[i]
            == t_pipe.noise_key_from_bits(bits))


def test_frame_noise_per_lane_equals_one_lane_at_a_time():
    """Keys [N, 3] and start frames [N] give each lane its own rows."""
    keys = t_pipe.lane_noise_keys(SEED, 3)
    starts = [-45, 0, 4090]
    bins = noise_bins(configs()[1])
    batched = t_pipe.frame_noise(torch.tensor(keys), torch.tensor(starts),
                                 20, bins, torch.zeros(1))
    assert batched.shape == (3, 20, bins, 2)
    for lane, (key, start) in enumerate(zip(keys, starts)):
        one = t_pipe.frame_noise(key, start, 20, bins, torch.zeros(1))
        np.testing.assert_array_equal(batched[lane].numpy(), one.numpy())


def _lane_run(server, lane_signals, n_chunks, lane_carry):
    """Feed each lane its signal (silence elsewhere); return per lane the
    output and the voicing of the frames each step made final."""
    S = server.chunk_samples
    outs, voicing = [], []
    for k in range(n_chunks):
        chunks = np.zeros((server.num_streams, S), np.float32)
        for lane, x in lane_signals.items():
            chunks[lane] = x[k * S: (k + 1) * S]
        outs.append(server.step(chunks))
        voicing.append({lane: np.asarray(lane_carry(lane).f0_cache[-20:]) > 0
                        for lane in lane_signals})
    return ({lane: np.concatenate([o[lane] for o in outs])
             for lane in lane_signals},
            {lane: np.stack([v[lane] for v in voicing])
             for lane in lane_signals})


def test_batched_lane_matches_jax_batched_server(setup):
    """Port lane 2 against JAX lane 2 (N = 8 on the 8 CPU devices), the
    same weights, seed and input: 2e-3 of the peak with identical
    voicing, and within tests/test_parallel.py's atol 3e-3."""
    jc, tc, jp, tp = setup
    jsrv = JServer(jp, jc, num_streams=8, mesh=make_mesh(model_parallel=1),
                   seed=SEED)
    tsrv = BatchedServer(tp, tc, num_streams=8, seed=SEED, device="cpu")
    S = tsrv.chunk_samples
    x = _signal("speechlike", 6, S)
    yj, vj = _lane_run(jsrv, {2: x}, 6,
                       lambda i: jax.tree.map(lambda c: c[i],
                                              jsrv._carries))
    yt, vt = _lane_run(tsrv, {2: x}, 6, tsrv.lane_carry)
    assert vj[2].any() and not vj[2].all()
    np.testing.assert_array_equal(vt[2], vj[2])
    assert rel_to_peak(yt[2], yj[2]) < 2e-3
    np.testing.assert_allclose(yt[2], yj[2], rtol=0, atol=3e-3)


def test_batched_lanes_match_single_streams(setup):
    """Two lanes with different signals, each against a port
    VoiceChangerStream with that lane's noise key."""
    _, tc, _, tp = setup
    srv = BatchedServer(tp, tc, num_streams=4, seed=SEED, device="cpu")
    S = srv.chunk_samples
    signals = {1: _signal("sweep", 6, S), 2: _signal("formant", 6, S)}
    yb, vb = _lane_run(srv, signals, 6, srv.lane_carry)
    keys = t_pipe.lane_noise_keys(SEED, 4)
    for lane, x in signals.items():
        single = VoiceChangerStream(tp, tc, noise_key=keys[lane],
                                    device="cpu")
        outs, voicing = [], []
        for k in range(6):
            single.add(x[k * S: (k + 1) * S])
            outs.append(single.process())
            voicing.append(single.final_f0() > 0)
        np.testing.assert_array_equal(vb[lane], np.stack(voicing))
        assert vb[lane].any()
        assert rel_to_peak(yb[lane], np.concatenate(outs)) < 2e-3


def _carry_leaves(server, lane):
    return [t.clone() for t in tree_leaves(server.lane_carry(lane))]


def test_live_mask_pauses_a_lane_bit_for_bit(setup):
    _, tc, _, tp = setup
    srv = BatchedServer(tp, tc, num_streams=4, seed=SEED, device="cpu")
    S = srv.chunk_samples
    rng = np.random.default_rng(0)
    srv.step(rng.standard_normal((4, S)).astype(np.float32) * 0.1)
    before = _carry_leaves(srv, 3)
    live = np.ones(4, bool)
    live[3] = False
    out = srv.step(rng.standard_normal((4, S)).astype(np.float32) * 0.1,
                   live=live)
    assert np.abs(out[3]).max() == 0.0
    assert np.isfinite(out).all() and np.abs(out[0]).max() > 0.0
    after = _carry_leaves(srv, 3)
    assert len(before) == len(after) > 10
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert int(srv.lane_carry(3).frame_pos) != int(srv.lane_carry(0)
                                                   .frame_pos)


@pytest.mark.parametrize("how", ["reset_stream", "reset_mask"])
def test_reset_puts_a_lane_back_to_the_init_carry(setup, how):
    """After a reset the lane's carry equals the init carry leaf for leaf
    (``reset_stream``), or the lane's next step equals a fresh stream's
    first step (the mask acts before the chunk)."""
    _, tc, _, tp = setup
    srv = BatchedServer(tp, tc, num_streams=3, seed=SEED, device="cpu")
    S = srv.chunk_samples
    x = _signal("harmonic", 3, S)
    chunks = np.stack([x[:S]] * 3)
    first = srv.step(chunks)
    srv.step(np.stack([x[S: 2 * S]] * 3))
    if how == "reset_stream":
        srv.reset_stream(1)
        for a, b in zip(tree_leaves(srv.lane_carry(1)),
                        tree_leaves(srv._init_carry)):
            assert torch.equal(a, b)
        assert not torch.equal(srv.lane_carry(0).wave_buf,
                               srv._init_carry.wave_buf)
        with pytest.raises(IndexError):
            srv.reset_stream(3)
    else:
        reset = np.array([False, True, False])
        again = srv.step(chunks, reset=reset)
        np.testing.assert_array_equal(again[1], first[1])
        assert not np.array_equal(again[0], first[0])


def test_num_streams_is_taken_as_given(setup):
    _, tc, _, tp = setup
    srv = BatchedServer(tp, tc, num_streams=5, device="cpu")
    assert srv.num_streams == 5
    out = srv.step(np.zeros((5, srv.chunk_samples), np.float32))
    assert out.shape == (5, srv.chunk_out_samples)
    with pytest.raises(ValueError):
        srv.step(np.zeros((8, srv.chunk_samples), np.float32))
    with pytest.raises(ValueError):
        srv.step(np.zeros((5, srv.chunk_samples), np.float32),
                 live=np.ones(4, bool))


def test_server_defaults_to_cuda_without_fallback(setup):
    _, tc, _, tp = setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedServer(tp, tc, num_streams=2)


def test_resample_matrices_are_built_when_a_stream_is_made(setup):
    """A 16 kHz in / 48 kHz out stream or server builds both matrices at
    construction, not in its first step."""
    _, tc, _, tp = setup
    cfg = dataclasses.replace(tc, dsp=dataclasses.replace(
        tc.dsp, input_rate=16000, output_rate=48000))
    for make in (lambda: VoiceChangerStream(tp, cfg, device="cpu"),
                 lambda: BatchedServer(tp, cfg, num_streams=2,
                                       device="cpu")):
        dft._const.cache_clear()
        t_rs._matrix_np.cache_clear()
        made = make()
        assert t_rs._matrix_np.cache_info().misses == 2
        if isinstance(made, BatchedServer):
            made.step(np.zeros((2, made.chunk_samples), np.float32))
        else:
            made.add(np.zeros(made.chunk_samples, np.float32))
            made.process()
        assert t_rs._matrix_np.cache_info().misses == 2
