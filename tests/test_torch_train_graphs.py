"""The training programs (``training/train_step.py:StepProgram``) on the CPU,
where a program runs its body eagerly over the same static buffers that a
CUDA graph captures on the card: the joint, GAN and fine-tune programs
against their eager step loops bit for bit (``chip_smoke.py`` phase 20's
helpers, run here on the CPU), the joint program's first step against the
JAX package's jitted step, the warm-up's snapshot and restore of a whole
training state, a checkpoint restored into a program's state, the
analysis program cache under ``make_batch``, launch records kept per
capturing stream, and the convolution backward that sums without atomics.
Tiny models (``torch_parity.training_configs``, tests/test_torch_training.py's
seeds and widths), 0.1 s batches, float32."""

import collections
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

import jax

import chip_smoke
from realtime_yukarin_tpu.training import train_step as j_ts
from realtime_yukarin_tpu_torch import pipeline as t_pl
from realtime_yukarin_tpu_torch.dsp.world import analyze
from realtime_yukarin_tpu_torch.models import discriminator as t_disc
from realtime_yukarin_tpu_torch.ops import conv, cuda
from realtime_yukarin_tpu_torch.parallel.mesh import Mesh
from realtime_yukarin_tpu_torch.training import checkpoint as t_ckpt
from realtime_yukarin_tpu_torch.training import train_step as t_ts
from realtime_yukarin_tpu_torch.training.data import make_batch, synth_batch

from test_torch_training import _flat_grads, _port_batch
from torch_parity import ALL_NETS, perturbed_params, training_configs

STEPS = 3


@pytest.fixture(scope="module")
def setup():
    jc, tc = training_configs()
    jp, tp, flat = perturbed_params(jc, tc, prefixes=ALL_NETS)
    disc = t_disc.init_discriminator(tc.super_resolution, tc.dsp,
                                     torch.Generator().manual_seed(1))
    batches = [make_batch(tc, 2, seconds=0.1, seed=s, device="cpu")
               for s in range(STEPS + 1)]
    return jc, tc, jp, tp, disc, batches


@pytest.fixture(scope="module")
def jax_first_step(setup):
    """The JAX package's jitted joint step, once, from the same weights on
    make_batch's seed-0 batch: (new state, metrics, batch)."""
    from realtime_yukarin_tpu.training.data import make_batch as j_batch
    jc, _, jp, _, _, _ = setup
    jb = j_batch(jc, 2, seconds=0.1, seed=0)
    state, metrics = jax.jit(j_ts.make_train_step(jc))(
        j_ts.init_train_state(jp), jb)
    return state, metrics, jb


def _runs(setup):
    _, tc, _, tp, disc, _ = setup
    return chip_smoke.training_runs(tc, "cpu", params=tp, disc=disc)


@pytest.mark.parametrize("objective", chip_smoke.TRAIN_OBJECTIVES)
def test_step_program_equals_the_eager_step_loop(setup, objective):
    """Three steps through the objective's program: after each, the
    metrics and every state leaf (parameters, moments, step counts, the
    EMA and the discriminator) equal the eager body's loop from the same
    state bit for bit."""
    run = _runs(setup)[objective]
    r = chip_smoke.train_replay_vs_eager(run, setup[5][:STEPS])
    assert r["mismatched"] == []
    assert r["state"].step == STEPS
    assert not r["step"].program.captured
    assert r["step"].summary().endswith("(CUDA graphs need a GPU)")


def test_eager_twice_is_bit_equal(setup):
    """Phase 20 (a)'s check on the CPU: two eager GAN runs from one
    state agree bit for bit."""
    assert chip_smoke.eager_twice(_runs(setup)["gan"], setup[5][:2])


def test_joint_program_first_step_matches_jax(setup, jax_first_step):
    """The joint program's first step against the JAX package's jitted
    step on the same batch: the metrics within 1e-4 relative, and the
    first Adam moments (0.1 x the clipped gradients) within 2e-3 of each
    subtree's peak (tests/test_torch_training.py's tolerances), zero for
    f0_stats."""
    _, tc, _, tp, _, _ = setup
    jstate, jm, jb = jax_first_step
    state = t_ts.init_train_state(tp, "cpu")
    step = t_ts.make_train_step(tc)
    state, tm = step(state, _port_batch(jb))
    assert state.step == 1 == int(jstate.step)
    for k in ("loss", "mc", "env", "stft", "wave"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    mu = next(x.mu for x in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(x, "mu"))
    from realtime_yukarin_tpu.models import voice_changer as j_vc
    from realtime_yukarin_tpu_torch.models.voice_changer import param_leaves
    jflat = j_vc.flatten_params(mu)
    tflat = _flat_grads(state.params, {
        k: [state.opt.state[p]["exp_avg"] for p in ps]
        for k, ps in param_leaves(state.params).items()})
    for stage in ("stage1", "stage2", "vocoder", "vocoder_wave"):
        names = [n for n in jflat if n.startswith(stage + "/")]
        peak = max(np.abs(jflat[n]).max() for n in names)
        err = max(np.abs(tflat[n] - jflat[n]).max() for n in names)
        assert peak > 0 and err / peak < 2e-3, (stage, err / peak)
    for n in ("src_mean", "src_std", "tgt_mean", "tgt_std"):
        assert tflat[f"f0_stats/{n}"] == 0 == jflat[f"f0_stats/{n}"]


@pytest.mark.parametrize("objective", ["joint", "gan"])
def test_warm_up_puts_the_training_state_back(setup, objective):
    """The warm-up runs the step's body once on the real state, then puts
    back every leaf (parameters, AdamW moments and step counts, the EMA,
    the discriminator and its optimizer); the next step still equals the
    eager loop's."""
    make_state, body, make_step, _ = _runs(setup)[objective]
    batches = setup[5]
    state, eager, step = make_state(), make_state(), make_step()
    step(state, batches[0])
    body(eager, batches[0])
    before = [t.clone() for t in t_ts.state_leaves(state)]
    calls = []
    inner = step.program._body
    step.program._body = lambda: calls.append(1) or inner()
    step.program.warm_up()
    assert len(calls) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(before, t_ts.state_leaves(state)))
    _, m = step(state, batches[1])
    assert chip_smoke.metrics_equal(body(eager, batches[1]), m)
    assert chip_smoke.states_equal(eager, state)


def test_restore_into_a_programs_state_is_read_by_the_next_step(setup,
                                                                 tmp_path):
    """A checkpoint restored into the state a program was built over lands
    in that state's own tensors (the optimizer's too), so the program is
    not rebuilt and its next step reads the restored state: it equals the
    eager body's step from the checkpointed state."""
    _, tc, _, tp, _, batches = setup
    make_state, body, make_step, _ = _runs(setup)["joint"]
    state, step = make_state(), make_step()
    step(state, batches[0])
    program = step.program
    ptrs = [t.data_ptr() for t in t_ts.state_leaves(state)]
    other = make_state()
    for b in batches[1:3]:
        body(other, b)
    other.step = 2
    t_ckpt.save_checkpoint(tmp_path, other, 2)
    restored, n = t_ckpt.restore_checkpoint(tmp_path, state)
    assert restored is state and n == 2 == state.step
    assert [t.data_ptr() for t in t_ts.state_leaves(state)] == ptrs
    assert chip_smoke.states_equal(state, other)
    _, m = step(state, batches[3])
    assert step.program is program
    assert chip_smoke.metrics_equal(body(other, batches[3]), m)
    assert chip_smoke.states_equal(state, other)


def test_a_multi_rank_step_stays_eager_and_says_why(setup):
    """Over several ranks a step's collectives are not captured: the
    step's program runs eagerly and its summary gives the reason."""
    tc = setup[1]
    mesh = Mesh(rank=0, world=2, model_parallel=1)
    for step in (t_ts.make_train_step(tc, mesh),
                 t_ts.make_gan_train_step(tc, mesh=mesh)):
        assert "2 ranks" in step.eager_reason
    assert t_ts.make_train_step(tc).eager_reason is None
    assert t_ts.make_train_step(
        tc, Mesh(rank=0, world=1, model_parallel=1)).eager_reason is None


def test_analysis_program_cache_and_make_batch(setup, monkeypatch):
    """offline_analyze: a length's first call runs eagerly and builds
    nothing, its second builds the program, every call equals the eager
    body bit for bit, the cache stays bounded; make_batch through it
    equals the batch built from eager ``analyze`` calls bit for bit."""
    tc = setup[1]
    monkeypatch.setattr(t_pl, "_programs", collections.OrderedDict())
    monkeypatch.setattr(t_pl, "PROGRAM_CACHE_SIZE", 2)
    hop = tc.dsp.hop
    rng = np.random.default_rng(5)

    def call(F):
        w = rng.standard_normal(F * hop).astype(np.float32)
        a = t_pl.offline_analyze(w, tc, F, device="cpu")
        b = t_pl.offline_analyze_eager(w, tc, F, device="cpu")
        for k in ("f0", "env", "ap", "mc"):
            assert torch.equal(getattr(a, k), getattr(b, k)), (F, k)

    def names():
        return [p.name for p in t_pl.cached_programs()]

    call(20)
    assert names() == []
    call(20)
    call(20)
    assert names() == ["analysis 20 frames"]
    call(24)
    call(24)
    call(28)
    assert names() == ["analysis 24 frames"]
    assert len(t_pl._programs) == 2

    srcs, tgts, noise = synth_batch(tc, 2, seconds=0.1, seed=0)
    F = noise.shape[1]
    feats = [analyze(torch.from_numpy(w), F, tc.dsp) for w in srcs + tgts]
    tb = make_batch(tc, 2, seconds=0.1, seed=0, device="cpu")

    def rows(k, fs):
        return torch.stack([torch.cat([getattr(f, k), getattr(f, k)[-1:]])
                            for f in fs])

    src, tgt = feats[:2], feats[2:]
    expect = {"f0_src": rows("f0", src), "mc_src": rows("mc", src),
              "ap_src": rows("ap", src), "f0_tgt": rows("f0", tgt),
              "mc_tgt": rows("mc", tgt), "env_tgt": rows("env", tgt),
              "f0_voc": rows("f0", tgt), "mc_voc": rows("mc", tgt),
              "ap_voc": rows("ap", tgt), "env_voc": rows("env", tgt),
              "wave_voc": torch.from_numpy(np.stack(tgts)),
              "noise": torch.from_numpy(noise)}
    for k, v in expect.items():
        assert torch.equal(getattr(tb, k), v), k


def test_synthesis_program_equals_the_eager_body(setup, monkeypatch):
    """offline_synthesize at one length, three keys: the eager first call,
    the program after, each equal to offline_synthesize_eager."""
    tc = setup[1]
    monkeypatch.setattr(t_pl, "_programs", collections.OrderedDict())
    srcs, _, noise = synth_batch(tc, 3, seconds=0.1, seed=2)
    F = noise.shape[1]
    feats = [t_pl.offline_analyze_eager(w, tc, F, "cpu") for w in srcs]
    r = chip_smoke.synthesis_replay_vs_eager(tc, feats, "cpu")
    assert r["equal"] and r["program"].name == f"synthesis {F} frames"


def test_a_launch_from_another_thread_is_recorded_per_stream(monkeypatch):
    """A launch made on the capturing stream from another thread (autograd
    runs a captured backward on its own thread) is recorded, not counted,
    and counted at each replay; so is a constant it holds.  A launch on a
    capturing stream with no record raises."""
    kernel = cuda.CudaKernel("stub", ())
    kernel._fn, kernel._err = (lambda *a: 0), (lambda code: b"")
    stream = {"handle": 7}
    monkeypatch.setattr(cuda, "current_stream", lambda: stream["handle"])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    const = torch.zeros(1)

    def worker():
        kernel.launch(1, 2)
        cuda.hold(const)

    with cuda.capturing(7) as capture:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert capture.launches == [(kernel, (1, 2))]
    assert capture.held == [const]
    assert kernel.launches == 0
    capture.replayed()
    capture.replayed()
    assert kernel.launches == 2
    stream["handle"] = 8
    with cuda.capturing(7), pytest.raises(RuntimeError,
                                          match="outside cuda.capturing"):
        kernel.launch(1, 2)
    assert cuda._captures == {}


@pytest.mark.parametrize("B,C,O,T,k,stride,padding", [
    (2, 3, 4, 11, 3, 1, 1), (2, 3, 5, 12, 5, 2, 0), (2, 3, 4, 13, 5, 2, 2),
    (3, 2, 3, 10, 1, 1, 0)])
def test_conv1d_backward_without_atomics(B, C, O, T, k, stride, padding):
    """ops/conv.py's backward (unfolded matmul, fold) against PyTorch's
    conv1d gradients in float64 and under gradcheck; the forward is
    conv1d's own."""
    gen = torch.Generator().manual_seed(B * 100 + T)
    x = torch.randn(B, C, T, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(O, C, k, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    y = conv.conv1d(x, w, stride, padding)
    ref = Fn.conv1d(x, w, stride=stride, padding=padding)
    assert torch.equal(y, ref)
    g = torch.randn(y.shape, dtype=torch.float64, generator=gen)
    for a, b in zip(torch.autograd.grad(y, (x, w), g),
                    torch.autograd.grad(ref, (x, w), g)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda a, b: conv.conv1d(a, b, stride, padding), (x, w))


def test_deterministic_restores_the_cudnn_flags():
    """The step's context turns cuDNN's autotuning off inside and puts
    the caller's setting back."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark
    try:
        cudnn.benchmark = True
        with t_ts.deterministic():
            assert cudnn.benchmark is False
        assert cudnn.benchmark is True
    finally:
        cudnn.benchmark = saved
