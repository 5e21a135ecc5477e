"""On the card only: each CUDA kernel of the PyTorch port against its plain
version at the main paths' widths, the launch counts, and one training step
through the kernels against the same step on the CPU.  Skips where there is
no GPU (a CUDA kernel has no CPU mode); on the GPU machine (no JAX there,
hence no conftest) run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import chip_smoke
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.ops import cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("R", chip_smoke.KERNEL_ROWS)
def test_kernels_match_plain_versions(device, R):
    cases = chip_smoke.kernel_cases(R, Config(), device,
                                    np.random.default_rng(R))
    for name, case in cases.items():
        before = chip_smoke.launch_counts()[name]
        _, err = chip_smoke.abs_rel_err(case.kernel(), case.plain())
        torch.cuda.synchronize()
        assert err <= chip_smoke.TOL[name], (name, err)
        assert chip_smoke.launch_counts()[name] == before + 1


@pytest.mark.parametrize("n,R", chip_smoke.RAGGED_CASES)
def test_analysis_kernels_at_ragged_rows_and_k513(device, n, R):
    """Both analysis kernels at ragged row counts and at fft_size 1024
    (K = 513): one launch per call, and every one of several back-to-back
    calls within tolerance of the plain version (the clusters exchange
    partial results through each other's shared memory; a race there
    shows as a call that disagrees)."""
    cases = chip_smoke.kernel_cases(R, Config(), device,
                                    np.random.default_rng(R), n=n)
    for name in chip_smoke.ANALYSIS_KERNELS:
        plain = cases[name].plain()
        for _ in range(3):
            before = chip_smoke.launch_counts()[name]
            out = cases[name].kernel()
            assert chip_smoke.launch_counts()[name] == before + 1
            assert out.shape == (R, n // 2 + 1)
            _, err = chip_smoke.abs_rel_err(out, plain)
            torch.cuda.synchronize()
            assert err <= chip_smoke.TOL[name], (name, err)


@pytest.mark.parametrize("R", [20, 21, 100])
def test_analysis_kernels_agree_on_every_one_of_many_calls(device, R):
    """1000 back-to-back calls of each analysis kernel at the streaming and
    make_batch widths, every result within tolerance of the plain version.
    The clusters hand partial results to each other's shared memory by bulk
    copies; a missing barrier before such a copy shows only now and then,
    as a call that disagrees."""
    cases = chip_smoke.kernel_cases(R, Config(), device,
                                    np.random.default_rng(R))
    for name in chip_smoke.ANALYSIS_KERNELS:
        plain = cases[name].plain()
        peak = plain.abs().max()
        errs = torch.stack([(cases[name].kernel() - plain).abs().max()
                            for _ in range(1000)]) / peak
        torch.cuda.synchronize()
        worst = float(errs.max())
        assert worst <= chip_smoke.TOL[name], (
            name, worst, int((errs > chip_smoke.TOL[name]).sum()))


@pytest.mark.parametrize("R", [100, 800])
def test_harmonic_bank_bwd_matches_plain_version(device, R):
    kernel, plain, *_ = chip_smoke.bwd_case(R, Config(), device,
                                            np.random.default_rng(R))
    before = cuda.HARMONIC_BANK_BWD.launches
    for k, p in zip(kernel(), plain()):
        _, err = chip_smoke.abs_rel_err(k, p)
        assert err <= chip_smoke.TOL["harmonic_bank_bwd"], err
    torch.cuda.synchronize()
    assert cuda.HARMONIC_BANK_BWD.launches == before + 1


@pytest.mark.parametrize("R", [100, 800])
def test_bank_backward_amplitudes_only_matches_plain_version(device, R):
    """The launch a training step makes (the phase and frac need no
    gradient): d_aL and d_aR only, within tolerance of the plain version,
    one launch, no d_phi or d_frac."""
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
    cfg = Config()
    al, ar, phi, frac, g = chip_smoke.bank_inputs(
        R, cfg.dsp.num_harmonics, cfg.dsp.hop, device,
        np.random.default_rng(R))
    before = cuda.HARMONIC_BANK_BWD.launches
    d_al, d_ar, d_phi, d_frac = hb._bank_backward(al, ar, phi, frac, g,
                                                  phase=False)
    p_al, p_ar, _, _ = hb.harmonic_bank_bwd_plain(al, ar, phi, frac, g)
    torch.cuda.synchronize()
    assert d_phi is None and d_frac is None
    for k, p in ((d_al, p_al), (d_ar, p_ar)):
        _, err = chip_smoke.abs_rel_err(k, p)
        assert err <= chip_smoke.TOL["harmonic_bank_bwd"], err
    assert cuda.HARMONIC_BANK_BWD.launches == before + 1


@pytest.mark.parametrize("R,H,hop", chip_smoke.BANK_RAGGED_CASES)
def test_bank_kernels_at_ragged_shapes(device, R, H, hop):
    """Both bank kernels at ragged rows, harmonics (one, one past a
    32-group, the COMPAT 128, 161) and hops (120, and 200: two sample
    chunks), one launch each, within tolerance of the plain versions."""
    before = (cuda.HARMONIC_BANK.launches, cuda.HARMONIC_BANK_BWD.launches)
    e_fwd, e_bwd = chip_smoke.bank_ragged(R, H, hop, device,
                                          np.random.default_rng(R + H + hop))
    torch.cuda.synchronize()
    assert e_fwd <= chip_smoke.TOL["harmonic_bank"], e_fwd
    assert e_bwd <= chip_smoke.TOL["harmonic_bank_bwd"], e_bwd
    assert (cuda.HARMONIC_BANK.launches,
            cuda.HARMONIC_BANK_BWD.launches) == (before[0] + 1, before[1] + 1)


def test_bank_wrappers_raise_for_what_the_kernels_do_not_take(device):
    """More harmonics than a block's shared memory holds: on CUDA tensors
    both wrappers raise before they launch (the plain versions would take
    them)."""
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
    a = torch.zeros((3, 20000), device=device)
    phi = torch.zeros((3, 120), device=device)
    frac = torch.zeros(120, device=device)
    before = (cuda.HARMONIC_BANK.launches, cuda.HARMONIC_BANK_BWD.launches)
    with pytest.raises(ValueError):
        hb.harmonic_bank(a, a, phi, frac)
    with pytest.raises(ValueError):
        hb.harmonic_bank_bwd(a, a, phi, frac, phi)
    assert (cuda.HARMONIC_BANK.launches,
            cuda.HARMONIC_BANK_BWD.launches) == before


@pytest.mark.parametrize("R", [20, 800])
def test_bank_kernels_agree_on_every_one_of_many_calls(device, R):
    """1000 back-to-back calls of each bank kernel at the streaming and
    training widths, every output of every call within tolerance of the
    plain version.  A row's segment warps add their partial sums in shared
    memory; a missing barrier there shows only now and then, as a call
    that disagrees."""
    from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
    cfg = Config()
    al, ar, phi, frac, g = chip_smoke.bank_inputs(
        R, cfg.dsp.num_harmonics, cfg.dsp.hop, device,
        np.random.default_rng(R))
    checks = {
        "harmonic_bank": (lambda: (hb.harmonic_bank(al, ar, phi, frac),),
                          (hb.harmonic_bank_plain(al, ar, phi, frac),)),
        "harmonic_bank_bwd": (
            lambda: hb.harmonic_bank_bwd(al, ar, phi, frac, g),
            hb.harmonic_bank_bwd_plain(al, ar, phi, frac, g)),
    }
    for name, (kernel, plain) in checks.items():
        peaks = [p.abs().max() for p in plain]
        errs = torch.stack([
            torch.stack([(o - p).abs().max() / pk
                         for o, p, pk in zip(kernel(), plain, peaks)]).max()
            for _ in range(1000)])
        torch.cuda.synchronize()
        worst = float(errs.max())
        assert worst <= chip_smoke.TOL[name], (
            name, worst, int((errs > chip_smoke.TOL[name]).sum()))


def test_training_step_through_the_kernels_matches_cpu(device):
    """A full-width training step on the card launches the bank's forward
    twice (the two vocoders' renders) and its backward once (only the DDSP
    render's amplitudes need a gradient); its losses and gradients match
    the CPU's at chip_smoke's parity tolerances (the wave decoder's leaf by
    leaf at the CUDA step's own loss cotangent).  At small widths the DDSP
    vocoder's step gradient is nearer the STFT loss's ill-conditioned
    regime (2.8e-3 of its peak at hidden 32 on the card), so the check runs
    at full width."""
    cuda.reset_counts()
    chip_smoke.train_parity(Config(), device)   # raises on disagreement
    torch.cuda.synchronize()
    # one step (bank forward x2, backward x1), then the wave decoder's
    # render (forward only: no parameter reaches its bank's amplitudes)
    assert cuda.HARMONIC_BANK.launches == 3
    assert cuda.HARMONIC_BANK_BWD.launches == 1


@pytest.mark.parametrize("R", [600, 601])
def test_analysis_kernels_at_the_offline_width(device, R):
    """An offline analysis of 3 s sends all R = 600 frames to each
    analysis kernel in one launch (the power spectrum's wide design, the
    envelope cepstrum's cluster design), and one more frame leaves a ragged
    tile: one launch per call (of either design), every one of several
    calls within tolerance of the plain version."""
    cases = chip_smoke.kernel_cases(R, Config(), device,
                                    np.random.default_rng(R))
    for name in chip_smoke.ANALYSIS_KERNELS:
        plain = cases[name].plain()
        for _ in range(3):
            before = chip_smoke.launch_counts()[name]
            _, err = chip_smoke.abs_rel_err(cases[name].kernel(), plain)
            torch.cuda.synchronize()
            assert chip_smoke.launch_counts()[name] == before + 1
            assert err <= chip_smoke.TOL[name], (name, err)


@pytest.mark.parametrize("mode", chip_smoke.VOCODER_MODES)
def test_offline_convert_through_the_kernels_matches_cpu(device, mode):
    """offline_convert on the card at the default Config in float32: one
    launch of each forward kernel (the whole utterance at once), the
    output within 2e-3 of the CPU's (the plain versions)."""
    import dataclasses

    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.pipeline import offline_convert
    cfg = dataclasses.replace(Config(), compute_dtype="float32")
    params = chip_smoke.vocoder_params(cfg)
    x = chip_smoke.test_signal(1.0, cfg.dsp.sample_rate, chip_smoke.SEED)
    F = len(x) // cfg.dsp.hop
    out = {}
    for dev in ("cpu", device):
        cuda.reset_counts()
        out[dev] = offline_convert(params_to(params, dev), x, (0, 1, 1), cfg,
                                   F, vocoder_mode=mode, device=dev).cpu()
    torch.cuda.synchronize()
    assert all(chip_smoke.launch_counts()[k] == 1
               for k in chip_smoke.FORWARD_KERNELS)
    _, err = chip_smoke.abs_rel_err(out[device], out["cpu"])
    assert err <= 2e-3, err


def test_batched_server_on_the_card(device):
    """64 streams in one step: lanes against single streams, a paused
    lane bit for bit, a reset lane, one launch of each forward kernel per
    step at R = 1280, no host sync in ``step_device`` (chip_smoke.py
    phase 12; raises on any failure)."""
    launches, _, _ = chip_smoke.batched_phase(Config())
    assert all(launches[k] == chip_smoke.BATCH_STEPS
               for k in chip_smoke.FORWARD_KERNELS)


@pytest.mark.parametrize("phase", ["socket_phase", "pipelined_phase",
                                   "first_chunk_phase"])
def test_host_edges_on_the_card(device, phase):
    """The socket server against single streams, the pipelined stream
    bit for bit and its soak, a 48 kHz client's first chunk
    (chip_smoke.py phases 14-16; each raises on failure)."""
    getattr(chip_smoke, phase)(Config())


@pytest.mark.parametrize("mode", chip_smoke.VOCODER_MODES)
def test_stream_replay_equals_eager(device, mode):
    """A VoiceChangerStream's captured program over 8 steps against the
    eager ``streaming_step`` loop, bit for bit (chip_smoke.py phase 19)."""
    cfg = Config()
    r = chip_smoke.stream_replay_vs_eager(chip_smoke.vocoder_params(cfg), cfg,
                                          mode, 8, device)
    assert r["program"].captured
    assert r["mismatched"] == []


def test_batched_replay_equals_eager_with_masks(device):
    """BatchedServer's captured program at 64 lanes over phase 12's
    schedule up to the reset (a paused lane, a reset lane) against
    ``make_batched_step``'s step, bit for bit; outputs held across the
    next step unchanged."""
    cfg = Config()
    r = chip_smoke.batched_replay_vs_eager(
        chip_smoke.seeded_params(cfg), cfg, chip_smoke.BATCH_STREAMS,
        chip_smoke.RESET_STEP + 2, device)
    assert r["program"].captured
    assert r["mismatched"] == []
    assert r["held"]


def test_one_launch_per_forward_kernel_per_replay(device):
    """Each forward kernel is captured once in the stream's graph and
    counted once per replay (ops/cuda.py's replay accounting)."""
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
    cfg = Config()
    stream = VoiceChangerStream(chip_smoke.seeded_params(cfg), cfg,
                                device=device)
    program = stream.program
    assert program.captured
    assert {k: program.kernel_launches.get(k, 0)
            for k in chip_smoke.FORWARD_KERNELS} == dict.fromkeys(
                chip_smoke.FORWARD_KERNELS, 1)
    cuda.reset_counts()
    for _ in range(3):
        stream.step_device(torch.zeros(stream.chunk_samples))
    torch.cuda.synchronize()
    assert all(chip_smoke.launch_counts()[k] == 3
               for k in chip_smoke.FORWARD_KERNELS)


def test_no_collection_during_a_capture(device):
    """The cyclic collector is off while a body is captured (a dropped
    program's graph, freed in the middle of another capture, invalidates
    it) and on again after it; the warm-up call runs with it on."""
    import gc

    from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram
    x = torch.zeros(8, device=device)
    seen = []

    def body():
        seen.append(gc.isenabled())
        return x + 1

    program = CapturedProgram(body, device=device)
    assert program.captured
    assert seen == [True, False]
    assert gc.isenabled()


def _small_training_config():
    """The quality recipe's tiny Config (tools/torch_quality.py), float32:
    a training program at small widths, quick to capture."""
    return chip_smoke.torch_quality().quality_config()


@pytest.mark.parametrize("objective", chip_smoke.TRAIN_OBJECTIVES)
def test_training_program_replays_equal_the_eager_body(device, objective):
    """Each training step captured on the card (kernel 4 inside its
    backward, launched on autograd's thread) replays bit-equal to its
    eager body over three steps, and two eager runs agree bit for bit;
    kernel 4 is counted once per replay."""
    from realtime_yukarin_tpu_torch.training.data import make_batch
    cfg = _small_training_config()
    run = chip_smoke.training_runs(cfg, device)[objective]
    batches = [make_batch(cfg, 2, seconds=0.2, seed=s, device=device)
               for s in range(3)]
    assert chip_smoke.eager_twice(run, batches[:2])
    r = chip_smoke.train_replay_vs_eager(run, batches)
    assert r["mismatched"] == []
    program = r["step"].program
    assert program.captured
    assert program.kernel_launches["harmonic_bank_bwd"] == 1
    cuda.reset_counts()
    for _ in range(2):
        r["step"](r["state"], r["batch"])
    torch.cuda.synchronize()
    assert cuda.HARMONIC_BANK_BWD.launches == 2


def test_a_host_sync_in_a_captured_backward_is_refused(device):
    """The capture mode refuses a host sync made from autograd's thread in
    a captured backward (the capture raises; no fallback), and the card
    stays usable."""
    from realtime_yukarin_tpu_torch.streaming.program import CapturedProgram

    class Syncing(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            float(g.sum())
            return 2 * g

    w = torch.ones(4, device=device, requires_grad=True)

    def body():
        return torch.autograd.grad(Syncing.apply(w).sum(), w)[0]

    with pytest.raises(Exception, match="captur"):
        CapturedProgram(body, state=(), device=device, differentiable=True)
    torch.cuda.synchronize()
    assert float(torch.ones(3, device=device).sum()) == 3.0


@pytest.mark.parametrize("F", [chip_smoke.TRAIN_FRAMES, 800])
def test_analysis_program_equals_the_eager_analysis(device, F):
    """The analysis program at make_batch's length and at a prepared
    file's bucket: the first call eager, the second captured, every call
    bit-equal to offline_analyze_eager; kernels 2 and 3 once per replay."""
    rng = np.random.default_rng(F)
    waves = [torch.from_numpy(rng.standard_normal(F * 120).astype(
        np.float32)) for _ in range(3)]
    r = chip_smoke.analysis_replay_vs_eager(Config(), waves, F, device)
    assert r["equal"] and r["program"].captured
    assert r["program"].kernel_launches == {"power_spectrum": 1,
                                            "envelope_cepstrum": 1}


@pytest.mark.parametrize("mode", chip_smoke.VOCODER_MODES)
def test_step_count_on_the_card_equals_the_cpu(device, mode):
    """``BatchedServer.count_step`` on the card: the CPU's FLOPs, bytes and
    learned-stage FLOPs at the same Config and weights, and the counted
    kernel launches those of one replay's launch record."""
    fails = []
    chip_smoke.count_step_both(chip_smoke.vocoder_params(Config()), Config(),
                               2, mode, mode, fails)
    assert not fails, fails


def test_step_count_refused_inside_a_capture(device):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    server = BatchedServer(chip_smoke.seeded_params(Config()), Config(),
                           num_streams=1, device=device)
    graph, one = torch.cuda.CUDAGraph(), torch.zeros(1, device=device)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                          capture_error_mode="thread_local"):
        one.add_(1.0)
        with pytest.raises(RuntimeError, match="capture"):
            server.step_cost_analysis()
