"""The ``"hifigan"`` vocoder mode (the HiFi-GAN V1 generator, the port's
alone) on the CPU at small widths, against the benchmark's plain float32
reference (``benchmark/reference/models/vocoder_hifigan.py`` and
``benchmark/reference/streaming/hifigan.py``): the generator alone, the
streaming step chunk by chunk, streamed == offline on the interior, the
batched server with joins and pauses against one stream per lane, the
server's program against its eager step bit for bit, the receptive field
against ``context_frames``, the generator over the rows its kept samples
depend on (``VocoderHiFiGANConfig.cone``) against the whole window bit for
bit, the stage markers, the step's cost against
``benchmark/formulas_hifigan.py``'s convention, the parameter file and both
CLIs.  Imports no JAX.

Tolerances, each relative to the compared output's RMS (or peak, where
the offline tests of the other modes use the peak):

* ``F32_TOL`` 1e-5: two float32 computations of the same convolutions
  (the reference pads explicitly and adds the bias apart) differ by
  rounding alone, 2e-7 of the RMS here; the same generator in bfloat16
  reads 7.5e-3, over seven hundred times the tolerance, and must fail it.
* ``STREAM_TOL`` 1e-5: the streaming step of the program and of the
  reference share every float32 formula up to the generator.
* streamed == offline, 2e-3 of the peak: the other modes' bound
  (``tests/test_torch_offline.py``), from the analysis' frame caches.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import formulas, formulas_hifigan
from benchmark.drivers.serve_vocoder import generator_weights
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.models.vocoder_hifigan import Generator
from benchmark.reference.streaming import hifigan as ref_hifigan
from benchmark.reference.streaming.state import StreamGeometry
from benchmark.weights import load_into, make_weights
from benchmark.reference.models.voice_changer import stage_nets as ref_nets
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models import vocoder_hifigan as vh
from realtime_yukarin_tpu_torch.models.vocoder_hifigan import (
    HiFiGANGenerator, hifigan_vocode)
from realtime_yukarin_tpu_torch.models.voice_changer import (
    flax_tensors, init_params, load_all_params, stage_nets)
from realtime_yukarin_tpu_torch.ops import hifigan_tail as ht
from realtime_yukarin_tpu_torch.parallel.serving import (BatchedServer,
                                                         make_batched_step,
                                                         model_stage_flops)
from realtime_yukarin_tpu_torch.pipeline import offline_convert_eager
from realtime_yukarin_tpu_torch.streaming.state import tree_leaves, tree_map
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.utils import cost, profiling

from conftest import make_test_signal

F32_TOL = 1e-5
STREAM_TOL = 1e-5
SMALL = {"acoustic": {"hidden": 32, "num_blocks": 2},
         "super_resolution": {"hidden": 64, "num_blocks": 2},
         "vocoder_nn": {"hidden": 32, "num_blocks": 2},
         "vocoder_wave": {"hidden": 32, "num_blocks": 2},
         "vocoder_hifigan": {"upsample_initial_channel": 16,
                             "resblock_kernel_sizes": [3, 5],
                             "resblock_dilation_sizes": [[1, 3], [1, 3]]},
         "vocoder_mode": "hifigan", "compute_dtype": "float32"}
SPEC = {"head_scale": 0.1, "bias_scale": 0.01,
        "f0_stats": {"src_mean": 160.0, "src_std": 0.25, "tgt_mean": 220.0,
                     "tgt_std": 0.25}}
CPU = torch.device("cpu")


def _generators(d: dict, seed: int = 3):
    """(program generator, reference generator) with the same weights, by
    the benchmark's rule, for config dict ``d``."""
    ref_d, h = ref_hifigan.split_config(d)
    ref_cfg = RefConfig.from_dict(ref_d)
    w = generator_weights(ref_cfg, h, SPEC, seed, CPU)
    cfg = Config.from_dict(d)
    prog = HiFiGANGenerator(cfg.vocoder_hifigan, cfg.dsp)
    ref = Generator(h, 67)
    for net in (prog, ref):
        net.load_state_dict({k: t.clone() for k, t in w.items()})
    return cfg, prog, ref, w


@pytest.fixture(scope="module")
def small():
    """The small config, its program params (generator included) and its
    reference params, from one draw of the benchmark's weights."""
    cfg, prog_g, ref_g, _ = _generators(SMALL)
    ref_d, h = ref_hifigan.split_config(SMALL)
    ref_cfg = RefConfig.from_dict(ref_d)
    w = make_weights(ref_cfg, SPEC, 4, CPU)
    params = {**load_into(stage_nets(cfg), w), "vocoder_hifigan": prog_g}
    ref_params = {**load_into(ref_nets(ref_cfg), w),
                  "vocoder_hifigan": ref_g}
    for v in (*params.values(), *ref_params.values()):
        if isinstance(v, torch.nn.Module):
            v.eval().requires_grad_(False)
    return cfg, params, ref_cfg, h, ref_params


def _signal(cfg, chunks: int, lanes: int = 1, seed: int = 0) -> np.ndarray:
    S = cfg.streaming.chunk_samples(cfg.dsp)
    return np.stack([make_test_signal("speechlike", chunks * S / 24000,
                                      24000, seed + k)[: chunks * S]
                     for k in range(lanes)]).astype(np.float32)


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_generator_matches_the_reference_and_bfloat16_does_not():
    _, prog, ref, _ = _generators(SMALL)
    x = torch.randn((2, 12, 67), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_ref = ref(x).numpy()
        y32 = prog(x, torch.float32).numpy()
        y16 = prog(x, torch.bfloat16).numpy()
    assert y32.shape == (2, 12 * 120) and np.sqrt(np.mean(y_ref ** 2)) > 1e-2
    assert _rel_rms(y32, y_ref) < F32_TOL
    assert _rel_rms(y16, y_ref) > 10 * F32_TOL


@pytest.mark.parametrize("d", [SMALL, {}], ids=["small", "published"])
def test_context_frames_is_the_measured_receptive_field(d):
    """Perturb one input frame; the output frames that move lie exactly
    ``context_frames`` away on the far side (the reference's forward
    count agrees).  In float64: the far taps' share of a sample falls
    under float32's rounding."""
    cfg, prog, _, _ = _generators({**d, "vocoder_mode": "hifigan"})
    ctx = cfg.vocoder_hifigan.context_frames
    assert ctx == ref_hifigan.split_config(d)[1].halo_frames
    T, j = 2 * ctx + 5, ctx + 2
    x = torch.randn((1, T, 67), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    x2 = x.clone()
    x2[0, j] += 1.0
    prog.double()
    with torch.no_grad():
        moved = (prog(x2, torch.float64)[0]
                 != prog(x, torch.float64)[0]).numpy()
    frames = np.flatnonzero(moved) // cfg.dsp.hop
    assert max(j - frames.min(), frames.max() - j) == ctx
    if not d:
        assert ctx == 21


@pytest.fixture
def one_order():
    """The CPU's convolutions summed in one order whatever their width:
    oneDNN, and MKL on several threads, choose their blocking by a
    convolution's shape, so one layer over two widths of the same rows
    rounds apart (at the published widths on an AVX-512 CPU: float32 by up
    to 4e-7, float64 by 5e-16, of outputs near 0.5); single-threaded
    without oneDNN each output row is summed alike at every width."""
    threads, onednn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = onednn


def _cone_cases():
    """(config, dtype, out_ctx as a function of the halo) of the cone
    test: SMALL and the published widths, float32 and float64, and the
    kept frames offline (0: the whole window bar the last frame), one in,
    at the halo and past it (the first layers then trimmed too)."""
    for name, d in (("small", SMALL), ("published", {})):
        for dtype in (torch.float32, torch.float64):
            for label, ctx in (("0", lambda c: 0), ("1", lambda c: 1),
                               ("halo", lambda c: c),
                               ("halo+3", lambda c: c + 3)):
                yield pytest.param(d, dtype, ctx, id=f"{name}-"
                                   f"{str(dtype)[6:]}-{label}")


@pytest.mark.parametrize("d,dtype,ctx", _cone_cases())
def test_the_cone_keeps_the_whole_windows_samples_bit_for_bit(
        d, dtype, ctx, one_order):
    """One lane of a streamed step's window (the chunk's 20 frames, one
    more and the halo on each side): the generator with ``out_ctx``
    equals the same window run whole (``forward`` without it, the parent
    step's computation), sliced to the kept frames, bit for bit."""
    cfg, prog, _, _ = _generators({**d, "vocoder_mode": "hifigan"})
    h = cfg.vocoder_hifigan
    out_ctx, hop = ctx(h.context_frames), cfg.dsp.hop
    T = cfg.streaming.chunk_frames(cfg.dsp) + 1 + 2 * h.context_frames
    x = torch.randn((1, T, 67), generator=torch.Generator().manual_seed(6),
                    dtype=dtype)
    prog.to(dtype)
    whole = prog(x, dtype)
    kept = prog(x, dtype, None, out_ctx)
    F = T - 1 - 2 * out_ctx
    assert kept.shape == (1, F * hop)
    assert torch.equal(kept, whole[:, out_ctx * hop: (out_ctx + F) * hop])


def _v1_forward(net, x, dtype, out_ctx):
    """HiFi-GAN V1's forward written out as one sequence of plain ops, in
    the order of the fused design: conv_pre and its leaky ReLU; per stage
    the transposed conv, its bias and leaky ReLU, then per resblock and
    dilation c1, its bias and leaky ReLU, c2, its bias and the residual,
    each resblock's output added to the stage's running sum, and the sum's
    mean and leaky ReLU (0.01 after the last stage); conv_post, its bias
    and tanh.  Each conv is the generator's own NHWC call on its packed
    weights, each pass ``hifigan_tail_plain``, each layer over its cone."""
    T, D = x.shape[-2:]
    w = net.packed(dtype)
    (lo, hi), *cone = net.cfg.cone(T, out_ctx, net.hop)

    def tail(mode, y, bias, window=None, **kw):
        start, length = (0, None) if window is None else window
        return ht.hifigan_tail_plain(mode, y, bias, length=length,
                                     start=start, **kw)
    (a,) = tail("act", vh._conv(x.reshape(-1, T, D)[:, lo: hi].to(dtype),
                                w.pre[0]), w.pre[1],
                (cone[0][0] - lo, cone[0][1] - cone[0][0]), slope=0.1)
    rates = net.cfg.upsample_rates
    n = len(net.cfg.resblock_kernel_sizes)
    for i, u in enumerate(rates):
        (lo, _), rows, out = cone[2 * i: 2 * i + 3]
        h, a = tail("up", vh._conv_up(a, w.ups[i][0], u), w.ups[i][1],
                    (rows[0] - lo * u, rows[1] - rows[0]), slope=0.1)
        acc = None
        for j, (layers, ds) in enumerate(zip(
                w.blocks[i], net.cfg.resblock_dilation_sizes)):
            x_, xa = h, a
            for m, (d, (w1, b1, w2, b2)) in enumerate(zip(ds, layers)):
                (t,) = tail("act", vh._conv(xa, w1, d), b1, slope=0.1)
                v = vh._conv(t, w2)
                if m < len(ds) - 1:
                    x_, xa = tail("res", v, b2, r=x_, slope=0.1)
                elif j < n - 1:
                    (acc,) = tail("sum", v, b2, r=x_, acc=acc)
                else:
                    (acc,) = tail(
                        "mean", v, b2, (out[0] - rows[0], out[1] - out[0]),
                        r=x_, acc=acc, divisor=float(n),
                        slope=0.01 if i + 1 == len(rates) else 0.1)
        a = acc
    (lo, _), keep = cone[-2:]
    y = vh._conv(a, w.post[0])[:, keep[0] - lo: keep[1] - lo]
    y = y.to(torch.promote_types(y.dtype, torch.float32)) + w.post[1]
    return torch.tanh(y).reshape(*x.shape[:-2], keep[1] - keep[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("whole", [True, False], ids=["whole", "cone"])
def test_the_generator_is_its_written_out_sequence_bit_for_bit(dtype,
                                                                whole):
    """The generator's forward (one skeleton with the bigvgan mode's, by
    hooks) equals :func:`_v1_forward`, the same layers written out as one
    plain sequence, bit for bit: no sum reordered, no pass moved, over the
    whole window and over a streamed step's cone."""
    cfg, prog, _, _ = _generators(SMALL)
    h = cfg.vocoder_hifigan
    T = cfg.streaming.chunk_frames(cfg.dsp) + 1 + 2 * h.context_frames
    x = torch.randn((2, T, 67), generator=torch.Generator().manual_seed(8))
    out_ctx = None if whole else h.context_frames
    with torch.no_grad():
        got = prog(x, dtype, None, out_ctx)
        want = _v1_forward(prog, x, dtype, out_ctx)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(want.abs().max()) > 1e-2
    assert torch.equal(got, want)


def test_the_cone_at_the_published_widths():
    """The rows each boundary runs at ``hifigan.serve256``'s window (63
    frames, the 21-frame halo): conv_pre's output 56, the stages' 268,
    583, 1,384 and 2,526 (of 315, 1,260, 3,780 and 7,560), conv_post's
    input 2,406 for the 2,400 kept.  Then the cone is the dependency cone:
    in float64 past the halo, one input frame just outside it leaves the
    kept samples of the whole window bit-equal, one just inside moves
    them, on either side."""
    cfg, prog, _, _ = _generators({"vocoder_mode": "hifigan"})
    h = cfg.vocoder_hifigan
    assert h.context_frames == 21
    cone = h.cone(63, 21)
    # conv_pre's input, then per stage its input and its rows, conv_post's
    # input and the kept samples
    assert [hi - lo for lo, hi in cone] == [62, 56, 268, 148, 583, 463,
                                            1384, 1264, 2526, 2406, 2400]
    assert cone[1] == (3, 59) and cone[-1] == (2520, 4920)
    assert h.cone(63, 0)[:5] == h.cone(63)[:5] == (
        (0, 63), (0, 63), (0, 315), (0, 315), (0, 1260))
    out_ctx = 24
    (lo, hi), keep = h.cone(63, out_ctx)[0], h.cone(63, out_ctx)[-1]
    assert (lo, hi) == (3, 59)
    x = torch.randn((1, 63, 67), generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    prog.double()

    def kept(j):
        x2 = x.clone()
        x2[0, j] += 1.0
        return prog(x2, torch.float64)[0, keep[0]: keep[1]]
    base = prog(x, torch.float64)[0, keep[0]: keep[1]]
    for outside in (lo - 1, hi):
        assert torch.equal(kept(outside), base), outside
    for inside in (lo, hi - 1):
        assert not torch.equal(kept(inside), base), inside


def test_streaming_step_matches_the_reference_chunk_by_chunk(small):
    cfg, params, ref_cfg, h, ref_params = small
    x = _signal(cfg, 6)
    stream = VoiceChangerStream(params, cfg, vocoder_mode="hifigan",
                                device="cpu")
    S = stream.chunk_samples
    prog = np.stack([stream.step_device(torch.from_numpy(x[0, t * S:
                                                            (t + 1) * S]))
                     .numpy() for t in range(6)])
    chunks = x[0].reshape(6, 1, S)
    ref = ref_hifigan.replay(ref_params, ref_cfg, h, chunks,
                             np.ones((6, 1), bool), CPU)[:, 0]
    level = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    assert level > 1e-3
    for t in range(6):
        err = np.sqrt(np.mean((prog[t] - ref[t]).astype(np.float64) ** 2))
        assert err / level < STREAM_TOL, t


def test_streamed_equals_offline_on_the_interior(small):
    cfg, params, _, _, _ = small
    x = _signal(cfg, 8)[0]
    F = len(x) // cfg.dsp.hop
    offline = offline_convert_eager(params, x, (0, 1, 1), cfg, F,
                                    vocoder_mode="hifigan",
                                    device="cpu").numpy()
    stream = VoiceChangerStream(params, cfg, vocoder_mode="hifigan",
                                device="cpu")
    S = stream.chunk_samples
    outs = [stream.step_device(torch.from_numpy(x[k * S: (k + 1) * S]))
            .numpy() for k in range(len(x) // S)]
    lat = stream.latency_samples
    streamed = np.concatenate(outs)[lat:]
    geo = stream._geo
    lo = (geo.model_ctx + 2) * cfg.dsp.hop
    hi = len(streamed) - 2 * cfg.dsp.hop
    assert hi - lo >= 10 * cfg.dsp.hop
    scale = np.abs(offline[lo:hi]).max()
    assert scale > 1e-2
    np.testing.assert_allclose(streamed[lo:hi] / scale,
                               offline[lo:hi] / scale, rtol=0, atol=2e-3)


def test_batched_server_with_joins_and_pauses_equals_one_stream_a_lane(
        small):
    """Lane 1 paused on ticks 2-3, lane 2 joined anew on tick 3: each lane
    equals a stream fed its own chunks (a fresh stream from the join), and
    a paused lane emits zeros."""
    cfg, params, _, _, _ = small
    T, N = 6, 3
    x = _signal(cfg, T, N)
    server = BatchedServer(params, cfg, num_streams=N,
                           vocoder_mode="hifigan", device="cpu")
    S = server.chunk_samples
    live = np.ones((T, N), bool)
    live[2:4, 1] = False
    reset = np.zeros((T, N), bool)
    reset[3, 2] = True
    outs = np.stack([server.step(x[:, t * S: (t + 1) * S], live[t],
                                 reset[t]) for t in range(T)])
    for lane in range(N):
        stream = VoiceChangerStream(params, cfg, vocoder_mode="hifigan",
                                    device="cpu")
        for t in range(T):
            if reset[t, lane]:
                stream = VoiceChangerStream(params, cfg,
                                            vocoder_mode="hifigan",
                                            device="cpu")
            if not live[t, lane]:
                assert not outs[t, lane].any()
                continue
            y = stream.step_device(torch.from_numpy(
                x[lane, t * S: (t + 1) * S])).numpy()
            np.testing.assert_allclose(outs[t, lane], y, rtol=0, atol=1e-6)


def test_server_program_equals_its_eager_step_bit_for_bit(small):
    cfg, params, _, _, _ = small
    N = 2
    server = BatchedServer(params, cfg, num_streams=N,
                           vocoder_mode="hifigan", device="cpu")
    step = make_batched_step(cfg, vocoder_mode="hifigan")
    init = server._init_carry
    carries = tree_map(lambda c: c.expand(N, *c.shape).clone(), init)
    x = torch.from_numpy(_signal(cfg, 3, N))
    S = server.chunk_samples
    for t in range(3):
        live = torch.tensor([True, t != 1])
        reset = torch.tensor([False, t == 2])
        c = x[:, t * S: (t + 1) * S]
        y = server.step_device(c, live, reset).clone()
        with torch.no_grad():
            y_ref, carries = step(server._params, init, carries, c,
                                  server._keys, live, reset)
        assert torch.equal(y, y_ref)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(server._carries), tree_leaves(carries)))


def test_the_mode_runs_no_sr_and_decodes_no_envelope(small, monkeypatch):
    """The generator reads mc, ap and F0 alone: SR's halo is not in the
    geometry (the generator's is, on both sides), and neither the streamed
    nor the offline step decodes an envelope or refines it."""
    from realtime_yukarin_tpu_torch.streaming.state import StreamGeometry \
        as ProgGeometry
    cfg, params, ref_cfg, h, _ = small
    geo = ProgGeometry.from_config(cfg, True, vocoder_mode="hifigan")
    assert geo == ProgGeometry.from_config(cfg, False,
                                           vocoder_mode="hifigan")
    assert geo.model_ctx == (cfg.acoustic.context_frames + cfg.dsp
                             .f0_edge_frames
                             + cfg.vocoder_hifigan.context_frames)
    assert dataclasses.asdict(geo) == dataclasses.asdict(
        ref_hifigan.geometry(ref_cfg, h))

    def refused(*args, **kw):
        raise AssertionError("the hifigan mode reads no envelope")
    for mod in ("streaming.pipeline", "models.voice_changer"):
        for fn in ("decode_mcep", "refine_envelope"):
            monkeypatch.setattr(f"realtime_yukarin_tpu_torch.{mod}.{fn}",
                                refused)
    x = _signal(cfg, 2)[0]
    stream = VoiceChangerStream(params, cfg, vocoder_mode="hifigan",
                                device="cpu")
    stream.step_device(torch.from_numpy(x[: stream.chunk_samples]))
    offline_convert_eager(params, x, (0, 1, 1), cfg, len(x) // cfg.dsp.hop,
                          vocoder_mode="hifigan", device="cpu")


def test_a_step_marks_the_generator_stages(small, monkeypatch):
    cfg, params, _, _, _ = small
    seen = []
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda stage, like: seen.append(stage))
    server = BatchedServer(params, cfg, num_streams=2,
                           vocoder_mode="hifigan", device="cpu")
    seen.clear()
    server.step(_signal(cfg, 1, 2))
    assert seen == ["carry_in", "resample_in", "analysis", "stage1",
                    "vocoder", "vocoder_s1", "vocoder_s2", "vocoder_s3",
                    "vocoder_s4", "vocoder", "resample_out", "carry_out",
                    "end"]
    assert set(seen) <= set(profiling.STAGES)


def test_ddsp_learned_flops_are_the_formulas_too():
    """``formulas_hifigan``'s count of another mode's vocoder, for a later
    cell of it: the DDSP control net over its rows."""
    d = {**SMALL, "vocoder_mode": "ddsp"}
    cfg = Config.from_dict(d)
    ref_cfg = RefConfig.from_dict(ref_hifigan.split_config(d)[0])
    server = BatchedServer(init_params(cfg, torch.Generator().manual_seed(0)),
                           cfg, num_streams=1, vocoder_mode="ddsp",
                           device="cpu")
    geo = StreamGeometry.from_config(ref_cfg, True, vocoder_mode="ddsp")
    assert sum(model_stage_flops(server).values()) == (
        formulas_hifigan.serve_learned_flops_mode(ref_cfg, geo, "ddsp"))


def _cone_flops(h, d_in: int, lanes: int, cone: tuple) -> int:
    """``formulas_hifigan``'s count (SAME taps included, a transposed
    conv's every tap) of the generator over each layer's rows of
    ``cone``."""
    (a, b), *cone = cone
    C = h.upsample_initial_channel
    flops = 2 * lanes * (b - a) * 7 * d_in * C
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes)):
        (a, b), (c, e) = cone[2 * i: 2 * i + 2]
        flops += 2 * lanes * (b - a) * k * C * h.channels(i)
        C = h.channels(i)
        flops += sum(2 * 2 * lanes * (e - c) * kr * C * C * len(ds)
                     for kr, ds in zip(h.resblock_kernel_sizes,
                                       h.resblock_dilation_sizes))
    a, b = cone[-2]
    return flops + 2 * lanes * (b - a) * 7 * C


def test_step_cost_counts_the_generator_as_the_formulas_do(small):
    """The step runs the generator over its cone: the count is
    ``formulas_hifigan``'s convention at the cone's rows, below its count
    of the whole window (the stale count of the benchmark's formulas),
    which the generator run whole gives."""
    cfg, params, ref_cfg, h, _ = small
    server = BatchedServer(params, cfg, num_streams=2,
                           vocoder_mode="hifigan", device="cpu")
    counted = model_stage_flops(server)
    rows = cfg.streaming.chunk_frames(cfg.dsp) + 1 + 2 * h.halo_frames
    assert counted["vocoder"] == 0 and counted["stage2"] == 0
    cone = cfg.vocoder_hifigan.cone(rows, h.halo_frames)
    window = formulas_hifigan.generator_flops(h, 67, 2, rows)
    assert counted["vocoder_hifigan"] == _cone_flops(
        cfg.vocoder_hifigan, 67, 2, cone) < window
    with torch.no_grad(), cost.StepCount() as count:
        params["vocoder_hifigan"](torch.zeros(2, rows, 67))
    assert count.flops == window
    geo = ref_hifigan.geometry(ref_cfg, h)
    assert counted["stage1"] == 2 * formulas.stage1_flops(
        ref_cfg, geo.chunk_frames)
    whole = server.step_cost_analysis()["flops"]
    assert whole > sum(counted.values())


def test_hifigan_params_are_built_and_loaded_in_that_mode_only(small,
                                                              tmp_path):
    cfg = small[0]
    dsp_cfg = Config.from_dict({**SMALL, "vocoder_mode": "dsp"})
    gen = torch.Generator().manual_seed(0)
    assert "vocoder_hifigan" not in init_params(dsp_cfg, gen)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert isinstance(params["vocoder_hifigan"], HiFiGANGenerator)
    # the stages drawn before the generator are the dsp mode's
    plain = init_params(dsp_cfg, torch.Generator().manual_seed(0))
    assert torch.equal(params["stage1"].stem.weight,
                       plain["stage1"].stem.weight)
    other = small[1]["vocoder_hifigan"]
    path = tmp_path / "g.npz"
    np.savez(path, **{f"params/{k}": (np.transpose(v.numpy())
                                      if k.endswith("/kernel")
                                      else v.numpy())
                      for k, v in flax_tensors(other).items()})
    loaded = load_all_params(params, dataclasses.replace(
        cfg, vocoder_hifigan_params_path=str(path)))
    for a, b in zip(loaded["vocoder_hifigan"].parameters(),
                    other.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="hifigan"):
        load_all_params(plain, dataclasses.replace(
            dsp_cfg, vocoder_hifigan_params_path=str(path)))


def test_both_clis_run_the_hifigan_mode(tmp_path):
    import json
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
                     "--vocoder", "hifigan"])
    y, rate = read_wav(str(tmp_path / "c.wav"))
    assert rate == 24000 and len(y) == n_in // 120 * 120
    assert np.abs(y).max() > 1e-3
    y, _ = read_wav(str(tmp_path / "s.wav"))
    assert len(y) >= n_in // 2400 * 2400 and np.abs(y).max() > 1e-3


def test_hifigan_vocode_keeps_the_centre_frames():
    cfg, prog, _, _ = _generators(SMALL)
    T, ctx = 10, 2
    x = torch.randn((T + 1 + 2 * ctx, 67),
                    generator=torch.Generator().manual_seed(5))
    f0 = torch.where(x[:, -1] > 0, 150.0, 0.0)
    mc, ap = x[:, :60], x[:, 60:65]
    with torch.no_grad():
        whole = hifigan_vocode(prog, f0, mc, ap)
        centre = hifigan_vocode(prog, f0, mc, ap, out_ctx=ctx)
    assert whole.shape == ((T + 2 * ctx) * 120,)
    assert torch.equal(centre, whole[ctx * 120: (ctx + T) * 120])
