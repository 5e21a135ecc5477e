"""The ``"bigvgan"`` vocoder mode (the BigVGAN v2 generator, the port's
alone) on the CPU at small widths (64 initial channels, all six stages),
against the benchmark's plain float32 reference
(``benchmark/reference/models/vocoder_bigvgan.py`` and
``benchmark/reference/streaming/bigvgan.py``): the generator alone, the
streaming step chunk by chunk, streamed == offline, the batched server
with joins and pauses against one stream per lane, the receptive field
against a brute-force probe, the generator over its dependency cone
against the whole window bit for bit, the activation's filter and its
plain pass against the reference's activation, the stage markers, the
parameter file and both CLIs.  Imports no JAX.

Tolerances, each relative to the compared output's RMS (or peak, where
the offline tests of the other modes use the peak):

* ``F32_TOL`` 5e-5: two float32 computations of the same generator (the
  reference pads explicitly, adds the bias apart, divides by beta where
  the program multiplies by its reciprocal) differ by rounding alone,
  carried through 36 convolutions and 37 snake activations a stage
  (under 1e-6 here); the same generator in bfloat16 reads about two
  hundred times the tolerance and must fail it.
* ``STREAM_TOL`` 5e-5: the streaming step of the program and of the
  reference share every float32 formula up to the generator.
* streamed == offline, 2e-3 of the peak: the other modes' bound
  (``tests/test_torch_offline.py``), from the analysis' frame caches.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.drivers.serve_bigvgan import generator_weights
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.models import vocoder_bigvgan as ref_model
from benchmark.reference.models.voice_changer import stage_nets as ref_nets
from benchmark.reference.streaming import bigvgan as ref_bigvgan
from benchmark.weights import load_into, make_weights
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.vocoder_bigvgan import (
    BigVGANGenerator, SnakeBeta)
from realtime_yukarin_tpu_torch.models.voice_changer import (
    flax_tensors, init_params, load_all_params, stage_nets)
from realtime_yukarin_tpu_torch.ops import bigvgan_act as ba
from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht
from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
from realtime_yukarin_tpu_torch.pipeline import offline_convert_eager
from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.utils import profiling

from conftest import make_test_signal

F32_TOL = 5e-5
STREAM_TOL = 5e-5
TINY = {"upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 3], [1, 3]]}
SMALL = {"acoustic": {"hidden": 32, "num_blocks": 2},
         "super_resolution": {"hidden": 64, "num_blocks": 2},
         "vocoder_nn": {"hidden": 32, "num_blocks": 2},
         "vocoder_wave": {"hidden": 32, "num_blocks": 2},
         "vocoder_bigvgan": TINY, "vocoder_mode": "bigvgan",
         "compute_dtype": "float32"}
# the benchmark's rule, with alpha and beta spread so the snake's period
# varies across channels
SPEC = {"head_scale": 0.1, "bias_scale": 0.01, "residual_scale": 0.2,
        "snake_log_spread": 0.5,
        "f0_stats": {"src_mean": 160.0, "src_std": 0.25, "tgt_mean": 220.0,
                     "tgt_std": 0.25}}
CPU = torch.device("cpu")


def _generators(d: dict, seed: int = 3):
    """(config, program generator, reference generator) with the same
    weights, by the benchmark's rule, for config dict ``d``."""
    ref_d, b = ref_bigvgan.split_config(d)
    w = generator_weights(RefConfig.from_dict(ref_d), b, SPEC, seed, CPU)
    cfg = Config.from_dict(d)
    prog = BigVGANGenerator(cfg.vocoder_bigvgan, cfg.dsp)
    ref = ref_model.Generator(b, 67)
    for net in (prog, ref):
        net.load_state_dict({k: t.clone() for k, t in w.items()})
    return cfg, prog, ref


@pytest.fixture(scope="module")
def small():
    """The small config, its program params (generator included) and its
    reference params, from one draw of the benchmark's weights."""
    cfg, prog_g, ref_g = _generators(SMALL)
    ref_d, b = ref_bigvgan.split_config(SMALL)
    ref_cfg = RefConfig.from_dict(ref_d)
    w = make_weights(ref_cfg, SPEC, 4, CPU)
    params = {**load_into(stage_nets(cfg), w), "vocoder_bigvgan": prog_g}
    ref_params = {**load_into(ref_nets(ref_cfg), w),
                  "vocoder_bigvgan": ref_g}
    for v in (*params.values(), *ref_params.values()):
        if isinstance(v, torch.nn.Module):
            v.eval().requires_grad_(False)
    return cfg, params, ref_cfg, b, ref_params


def _signal(cfg, chunks: int, lanes: int = 1, seed: int = 0) -> np.ndarray:
    S = cfg.streaming.chunk_samples(cfg.dsp)
    return np.stack([make_test_signal("speechlike", chunks * S / 24000,
                                      24000, seed + k)[: chunks * S]
                     for k in range(lanes)]).astype(np.float32)


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_the_filter_is_the_published_formula():
    """12 taps at times -5.5 ... 5.5, symmetric, summing to 1, from a
    Kaiser window of beta 4.6638 (0.1102 (A - 8.7) at A = 2.285 * 5 * pi
    * 1.2 + 7.95); the reference's copy is the same filter."""
    f = ba.act_filter()
    A = 2.285 * 5 * np.pi * 1.2 + 7.95
    assert round(0.1102 * (A - 8.7), 4) == 4.6638
    t = np.arange(-6, 6) + 0.5
    want = 0.5 * np.kaiser(12, 0.1102 * (A - 8.7)) * np.sinc(0.5 * t)
    np.testing.assert_allclose(f, want / want.sum(), rtol=1e-6)
    assert f.shape == (12,) and np.array_equal(f, f[::-1])
    assert abs(float(f.astype(np.float64).sum()) - 1.0) < 1e-6
    np.testing.assert_allclose(ref_model.kaiser_sinc().numpy(), f,
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("start,length,T", [(0, 40, 40), (0, 7, 40),
                                            (33, 7, 40), (12, 9, 40),
                                            (3, 2, 6), (0, 1, 1)],
                         ids=["whole", "left_edge", "right_edge", "inside",
                              "short", "one_row"])
def test_the_plain_pass_is_the_references_activation(start, length, T):
    """The pass's activation over a window of the operand, at its true
    edges (replicated) and inside (read on), against the reference's
    ``act`` over the whole operand, sliced; v with the bias, residual,
    sum and divisor as the plain pass forms it."""
    g = torch.Generator().manual_seed(start * 7 + length)
    C = 6
    y, r, acc = (torch.randn((2, T, C), generator=g) for _ in range(3))
    bias = torch.randn(C, generator=g)
    snake = ref_model.SnakeBeta(C)
    with torch.no_grad():
        snake.alpha.copy_(0.5 * torch.randn(C, generator=g))
        snake.beta.copy_(0.5 * torch.randn(C, generator=g))
    port = SnakeBeta(C)
    port.load_state_dict(snake.state_dict())
    v = (acc + (r + (y + bias))) / 3.0
    with torch.no_grad():
        want = ref_model.act(v.transpose(1, 2), snake).transpose(1, 2)
        (got,) = ba.bigvgan_act(y, port.packed(torch.float32), bias, r,
                                acc, divisor=3.0, start=start,
                                length=length)
    assert got.shape == (2, length, C)
    kept = slice(start, start + length)
    assert _rel_rms(got, want[:, kept]) < 1e-6
    with torch.no_grad():
        v_kept, a = ba.bigvgan_act(y, port.packed(torch.float32), bias, r,
                                   keep_v=True, start=start, length=length)
    assert torch.equal(v_kept, (r + (y + bias))[:, kept])


def test_generator_matches_the_reference_and_bfloat16_does_not():
    """Frames [2, 24, 67] (12 conditioning rows of pairs): the program's
    generator against the reference's over the pairs' means."""
    _, prog, ref = _generators(SMALL)
    x = torch.randn((2, 24, 67), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_ref = ref(ref_bigvgan.pairs(x)).numpy()
        y32 = prog(x, torch.float32).numpy()
        y16 = prog(x, torch.bfloat16).numpy()
    assert y32.shape == (2, 12 * 240)
    rms = np.sqrt(np.mean(y_ref ** 2))
    assert rms > 1e-2 and np.mean(np.abs(y_ref) > 0.99) < 0.5
    assert _rel_rms(y32, y_ref) < F32_TOL
    assert _rel_rms(y16, y_ref) > 20 * F32_TOL


@pytest.mark.parametrize("d", [SMALL, {}], ids=["small", "published"])
def test_context_frames_is_the_measured_receptive_field(d):
    """Perturb one frame of conditioning row j; the output rows that move
    lie exactly ``context_frames`` away on the far side (the reference's
    forward count agrees); the halo is twice that in frames.  The
    perturbation is infinitesimal (forward-mode, float64): a far row moves
    by the product of every layer's outermost tap on the way (the
    activations' filters' are ~1e-4), 1e-70 of the near rows' motion at
    the small widths, which no finite perturbation shows above float64's
    rounding; conv_post scaled down so that no sample meets the clamp.
    At the published widths the probe runs on the layer walk alone (the
    published generator is too wide for this CPU)."""
    import torch.autograd.forward_ad as fwAD
    d = {**d, "vocoder_mode": "bigvgan"}
    cfg = Config.from_dict(d)
    b = cfg.vocoder_bigvgan
    ctx = b.context_frames
    ref_b = ref_bigvgan.split_config(d)[1]
    assert ctx == ref_b.halo_rows
    assert b.halo_frames(cfg.dsp.hop) == 2 * ctx == ref_bigvgan.halo_frames(
        ref_b)
    if d.get("vocoder_bigvgan") is None:
        assert ctx == 34
        return
    _, prog, _ = _generators(d)
    prog.double()
    with torch.no_grad():
        prog.conv_post.weight.mul_(1e-3)
    T, j = 2 * ctx + 5, ctx + 2
    x = torch.randn((1, 2 * T, 67), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    tangent = torch.zeros_like(x)
    tangent[0, 2 * j] = 1.0          # one frame of row j
    with fwAD.dual_level():
        y = prog(fwAD.make_dual(x, tangent), torch.float64)
        moved = (fwAD.unpack_dual(y).tangent[0] != 0).numpy()
    assert float(y.abs().max()) < 0.5
    rows = np.flatnonzero(moved) // b.samples_per_frame
    assert max(j - rows.min(), rows.max() - j) == ctx


@pytest.fixture
def one_order():
    """The CPU's convolutions summed in one order whatever their width
    (as ``tests/test_torch_hifigan.py`` holds its cone)."""
    threads, onednn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = onednn


@pytest.mark.parametrize("label", ["0", "halo", "halo+2"])
def test_the_cone_keeps_the_whole_windows_samples_bit_for_bit(label,
                                                              one_order):
    """One lane of a streamed step's window (the chunk's 20 frames, one
    more and the halo on each side): the generator with ``out_ctx`` equals
    the window run whole, sliced to the kept frames, bit for bit."""
    cfg, prog, _ = _generators(SMALL)
    halo, hop = cfg.vocoder_bigvgan.halo_frames(120), cfg.dsp.hop
    out_ctx = {"0": 0, "halo": halo, "halo+2": halo + 2}[label]
    T = cfg.streaming.chunk_frames(cfg.dsp) + 1 + 2 * halo
    x = torch.randn((1, T, 67), generator=torch.Generator().manual_seed(6))
    whole = prog(x)
    kept = prog(x, torch.float32, None, out_ctx)
    F = T - 1 - 2 * out_ctx
    assert kept.shape == (1, F * hop)
    assert torch.equal(kept, whole[:, out_ctx * hop: (out_ctx + F) * hop])


def test_the_cone_at_the_published_widths():
    """The rows each boundary runs at ``bigvgan.serve128``'s window (157
    frames, 78 conditioning rows, the 68-frame halo): conv_pre's output
    72, the stages' 349, 502, 642, 922, 1,480 and 2,596 (of 390, 1,170,
    2,340, 4,680, 9,360 and 18,720), activation_post's input 2,416,
    conv_post's 2,406 for the 2,400 kept; the window starts on a pair."""
    cfg = Config.from_dict({"vocoder_mode": "bigvgan"})
    b = cfg.vocoder_bigvgan
    geo = StreamGeometry.from_config(cfg, vocoder_mode="bigvgan")
    halo = b.halo_frames(cfg.dsp.hop)
    assert (halo, geo.model_ctx, geo.delay_frames) == (68, 85, 90)
    T = geo.chunk_frames + 1 + 2 * halo
    cone = b.cone(T, halo, cfg.dsp.hop)
    assert [hi - lo for lo, hi in cone] == [
        78, 72, 349, 169, 502, 322, 642, 462, 922, 742, 1480, 1300, 2596,
        2416, 2406, 2400]
    assert cone[-1] == (8160, 10560)


def test_streaming_step_matches_the_reference_chunk_by_chunk(small):
    cfg, params, ref_cfg, b, ref_params = small
    x = _signal(cfg, 6)
    stream = VoiceChangerStream(params, cfg, vocoder_mode="bigvgan",
                                device="cpu")
    S = stream.chunk_samples
    prog = np.stack([stream.step_device(torch.from_numpy(x[0, t * S:
                                                            (t + 1) * S]))
                     .numpy() for t in range(6)])
    ref = ref_bigvgan.replay(ref_params, ref_cfg, b, x[0].reshape(6, 1, S),
                             np.ones((6, 1), bool), CPU)[:, 0]
    level = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    assert level > 1e-3
    assert dataclasses.asdict(stream._geo) == dataclasses.asdict(
        ref_bigvgan.geometry(ref_cfg, b))
    for t in range(6):
        err = np.sqrt(np.mean((prog[t] - ref[t]).astype(np.float64) ** 2))
        assert err / level < STREAM_TOL, t


def test_streamed_equals_offline_on_the_interior(small):
    """The pairs of a streamed step's window lie on the offline pairs'
    grid (D even, the halo whole pairs), so the streamed output past the
    delay is the offline output."""
    cfg, params, _, _, _ = small
    x = _signal(cfg, 12)[0]
    F = len(x) // cfg.dsp.hop
    offline = offline_convert_eager(params, x, (0, 1, 1), cfg, F,
                                    vocoder_mode="bigvgan",
                                    device="cpu").numpy()
    stream = VoiceChangerStream(params, cfg, vocoder_mode="bigvgan",
                                device="cpu")
    S = stream.chunk_samples
    outs = [stream.step_device(torch.from_numpy(x[k * S: (k + 1) * S]))
            .numpy() for k in range(len(x) // S)]
    lat = stream.latency_samples
    assert stream._geo.delay_frames % 2 == 0
    streamed = np.concatenate(outs)[lat:]
    lo = (stream._geo.model_ctx + 2) * cfg.dsp.hop
    hi = len(streamed) - 2 * cfg.dsp.hop
    assert hi - lo >= 10 * cfg.dsp.hop
    scale = np.abs(offline[lo:hi]).max()
    assert scale > 1e-2
    np.testing.assert_allclose(streamed[lo:hi] / scale,
                               offline[lo:hi] / scale, rtol=0, atol=2e-3)


def test_batched_server_with_joins_and_pauses_equals_one_stream_a_lane(
        small, one_order):
    """Lane 1 paused on tick 2, lane 2 joined anew on tick 3: each lane
    equals a stream fed its own chunks (a fresh stream from the join), and
    a paused lane emits zeros.  In one summation order (``one_order``):
    the snakes carry a convolution's rounding at another batch width to
    2e-5 of the output where the leaky ReLU's leave it under 1e-6."""
    cfg, params, _, _, _ = small
    T, N = 4, 3
    x = _signal(cfg, T, N)
    server = BatchedServer(params, cfg, num_streams=N,
                           vocoder_mode="bigvgan", device="cpu")
    S = server.chunk_samples
    live = np.ones((T, N), bool)
    live[2, 1] = False
    reset = np.zeros((T, N), bool)
    reset[3, 2] = True
    outs = np.stack([server.step(x[:, t * S: (t + 1) * S], live[t],
                                 reset[t]) for t in range(T)])
    for lane in range(N):
        stream = VoiceChangerStream(params, cfg, vocoder_mode="bigvgan",
                                    device="cpu")
        for t in range(T):
            if reset[t, lane]:
                stream = VoiceChangerStream(params, cfg,
                                            vocoder_mode="bigvgan",
                                            device="cpu")
            if not live[t, lane]:
                assert not outs[t, lane].any()
                continue
            y = stream.step_device(torch.from_numpy(
                x[lane, t * S: (t + 1) * S])).numpy()
            np.testing.assert_allclose(outs[t, lane], y, rtol=0, atol=1e-6)


def test_a_step_marks_the_six_stages(small, monkeypatch):
    cfg, params, _, _, _ = small
    seen = []
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda stage, like: seen.append(stage))
    server = BatchedServer(params, cfg, num_streams=2,
                           vocoder_mode="bigvgan", device="cpu")
    seen.clear()
    server.step(_signal(cfg, 1, 2))
    assert seen == ["carry_in", "resample_in", "analysis", "stage1",
                    "vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3",
                    "vocoder_s4", "vocoder_s5", "vocoder_s6", "vocoder",
                    "resample_out", "carry_out", "end"]


def test_the_passes_between_two_convs(small):
    """A forward launches one pass per gap between two convolutions:
    conv_pre's bias, then per stage 1 + (blocks - 1) + 2 x dilations a
    block.  Those an activation follows are ``bigvgan_act``'s (the last
    stage's mean too, which carries activation_post); conv_pre's bias, each
    block's last sum and the other stages' means are ``hifigan_tail``'s at
    slope 1: 109 and 18 at the published widths."""
    from realtime_yukarin_tpu_torch.utils import cost
    cfg, params, _, _, _ = small
    b = cfg.vocoder_bigvgan
    with torch.no_grad(), cost.StepCount() as count:
        params["vocoder_bigvgan"](torch.zeros(1, 2 * 20, 67))
    acts = [k for k in count.kernels if k.name == "bigvgan_act"]
    tails = [k for k in count.kernels if k.name == "hifigan_tail"]
    blocks = len(b.resblock_kernel_sizes)
    per_stage = 1 + (blocks - 1) + 2 * sum(
        len(ds) for ds in b.resblock_dilation_sizes)
    assert len(acts) == 6 * (per_stage - blocks) + 1
    assert len(tails) == 1 + 6 * blocks - 1
    # conv_pre's bias ("act"), the sums, the first five stages' means
    modes = [ht.MODES[k.shape[3]] for k in tails]
    assert modes == ["act"] + (["sum"] * (blocks - 1) + ["mean"]) * 5 + [
        "sum"] * (blocks - 1)
    published = Config().vocoder_bigvgan
    assert len(published.resblock_kernel_sizes) == 3 and all(
        len(ds) == 3 for ds in published.resblock_dilation_sizes)
    assert 6 * (1 + 2 + 2 * 9 - 3) + 1 == 109 and 1 + 6 * 3 - 1 == 18


def test_bigvgan_params_are_built_and_loaded_in_that_mode_only(small,
                                                              tmp_path):
    """The generator (alpha and beta included, conv_post without bias) in
    the ``.npz`` layout, loaded by ``vocoder_bigvgan_params_path``."""
    cfg = small[0]
    dsp_cfg = Config.from_dict({**SMALL, "vocoder_mode": "dsp"})
    assert "vocoder_bigvgan" not in init_params(dsp_cfg,
                                                torch.Generator())
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert isinstance(params["vocoder_bigvgan"], BigVGANGenerator)
    other = small[1]["vocoder_bigvgan"]
    names = flax_tensors(other)
    assert "conv_post/bias" not in names and "conv_post/kernel" in names
    assert "activation_post/alpha" in names
    assert "resblocks_0/activations_3/beta" in names
    path = tmp_path / "g.npz"
    np.savez(path, **{f"params/{k}": (np.transpose(v.numpy())
                                      if k.endswith("/kernel")
                                      else v.numpy())
                      for k, v in names.items()})
    loaded = load_all_params(params, dataclasses.replace(
        cfg, vocoder_bigvgan_params_path=str(path)))
    for a, b in zip(loaded["vocoder_bigvgan"].parameters(),
                    other.parameters()):
        assert torch.equal(a, b)
    plain = init_params(dsp_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bigvgan"):
        load_all_params(plain, dataclasses.replace(
            dsp_cfg, vocoder_bigvgan_params_path=str(path)))


def test_an_odd_chunk_is_refused():
    """The pairs need whole pairs a chunk: 15 ms is three frames."""
    cfg = Config.from_dict({"vocoder_mode": "bigvgan",
                            "streaming": {"chunk_ms": 15.0}})
    with pytest.raises(ValueError, match="whole number"):
        StreamGeometry.from_config(cfg, vocoder_mode="bigvgan")


def test_both_clis_run_the_bigvgan_mode(tmp_path):
    from realtime_yukarin_tpu_torch.cli.convert import main as convert
    from realtime_yukarin_tpu_torch.cli.serve import main as serve
    from realtime_yukarin_tpu_torch.utils.audio_io import read_wav, write_wav
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(json.dumps(SMALL))
    wav = tmp_path / "in.wav"
    write_wav(str(wav), make_test_signal("speechlike", 0.5, 24000), 24000)
    n_in = len(read_wav(str(wav))[0])
    for main, args in ((convert, ["--input_path", str(wav), "--output_path",
                                  str(tmp_path / "c.wav")]),
                       (serve, ["--input_wav", str(wav), "--output_wav",
                                str(tmp_path / "s.wav")])):
        main(args + ["--config_path", str(cfg_path), "--device", "cpu",
                     "--vocoder", "bigvgan"])
    y, rate = read_wav(str(tmp_path / "c.wav"))
    assert rate == 24000 and len(y) == n_in // 120 * 120
    assert np.abs(y).max() > 1e-3
    y, _ = read_wav(str(tmp_path / "s.wav"))
    assert len(y) >= n_in // 2400 * 2400 and np.abs(y).max() > 1e-3
