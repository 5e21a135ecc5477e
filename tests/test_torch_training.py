"""The port's training path against the JAX package's on the CPU: both
neural vocoders, the discriminator, the losses, the weights' round trip,
``loss_fn`` and its gradients, one optimizer step, the GAN step,
``make_batch``, checkpoints and ``cli.train``.  Tiny models
(``torch_parity.training_configs``), 0.1 s batches, float32; the JAX side
runs jitted on the CPU.  A CPU tensor never launches a kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_yukarin_tpu.models import discriminator as j_disc
from realtime_yukarin_tpu.models import voice_changer as j_vc
from realtime_yukarin_tpu.models.vocoder_nn import neural_vocode as j_nv
from realtime_yukarin_tpu.models.vocoder_wave import (waveform_vocode as
                                                      j_wv)
from realtime_yukarin_tpu.training import losses as j_losses
from realtime_yukarin_tpu.training import train_step as j_ts
from realtime_yukarin_tpu.training.data import make_batch as j_make_batch
from realtime_yukarin_tpu_torch.cli import train as t_cli
from realtime_yukarin_tpu_torch.dsp import synthesis as t_syn
from realtime_yukarin_tpu_torch.models import discriminator as t_disc
from realtime_yukarin_tpu_torch.models import voice_changer as t_vc
from realtime_yukarin_tpu_torch.models.vocoder_nn import neural_vocode
from realtime_yukarin_tpu_torch.models.vocoder_wave import waveform_vocode
from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.training import checkpoint as t_ckpt
from realtime_yukarin_tpu_torch.training import losses as t_losses
from realtime_yukarin_tpu_torch.training import train_step as t_ts
from realtime_yukarin_tpu_torch.training.data import make_batch

from torch_parity import (ALL_NETS, perturbed_params, rel_to_peak, t32,
                          training_configs)

TINY_YAML = """\
acoustic: {hidden: 32, num_blocks: 2}
super_resolution: {hidden: 64, num_blocks: 2}
vocoder_nn: {hidden: 32, num_blocks: 2}
vocoder_wave: {hidden: 32, num_blocks: 2, phase_harmonics: 4,
               phase_fractional: 2}
compute_dtype: float32
"""


@pytest.fixture(autouse=True)
def _zero_counts():
    cuda.reset_counts()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS)


@pytest.fixture(scope="module")
def setup():
    jc, tc = training_configs()
    jp, tp, flat = perturbed_params(jc, tc, prefixes=ALL_NETS)
    return jc, tc, jp, tp, flat


@pytest.fixture(scope="module")
def jbatch(setup):
    """The JAX package's make_batch: 2 utterances of 0.1 s, seed 0."""
    return j_make_batch(setup[0], 2, seconds=0.1, seed=0)


def _port_batch(jb) -> t_ts.Batch:
    return t_ts.Batch(**{k: t32(v) for k, v in jb._asdict().items()})


def _controls(cfg, B, F, seed):
    """Seeded vocoder inputs: f0 [B, F+1] with unvoiced stretches, env,
    ap, mc, noise."""
    rng = np.random.default_rng(seed)
    d = cfg.dsp
    f0 = np.where(rng.uniform(0, 1, (B, F + 1)) > 0.2,
                  rng.uniform(90, 260, (B, F + 1)), 0.0)
    env = np.exp(rng.uniform(-10, -2, (B, F + 1, d.spec_bins)))
    ap = rng.uniform(0, 1, (B, F + 1, d.num_ap_bands))
    mc = 0.5 * rng.standard_normal((B, F + 1, d.mc_dim))
    noise = rng.standard_normal((B, F, t_syn.prim.noise_fft_size(d.hop)
                                 // 2 + 1, 2))
    return [a.astype(np.float32) for a in (f0, env, ap, mc, noise)]


def _port_grads(params, flat_grads):
    """Gradients given in the flax layout -> the port's subtree lists."""
    by_id = {}
    for stage in t_vc.NETS:
        for path, t in t_vc.flax_tensors(params[stage]).items():
            g = np.asarray(flat_grads[f"{stage}/params/{path}"], np.float32)
            by_id[id(t)] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(g) if path.endswith("/kernel") else g))
    for n in t_vc.F0_STAT_NAMES:
        by_id[id(params["f0_stats"][n])] = torch.tensor(
            np.float32(flat_grads[f"f0_stats/{n}"]))
    return {k: [by_id[id(p)] for p in ps]
            for k, ps in t_vc.param_leaves(params).items()}


def _flat_grads(params, grads):
    """The port's subtree gradient lists -> the flax layout."""
    g_by_id = {id(p): g for k, ps in t_vc.param_leaves(params).items()
               for p, g in zip(ps, grads[k])}
    out = {}
    for stage in t_vc.NETS:
        for path, t in t_vc.flax_tensors(params[stage]).items():
            g = g_by_id[id(t)].numpy()
            out[f"{stage}/params/{path}"] = (np.transpose(g)
                                            if path.endswith("/kernel")
                                            else g)
    for n in t_vc.F0_STAT_NAMES:
        out[f"f0_stats/{n}"] = g_by_id[id(params["f0_stats"][n])].numpy()
    return out


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def test_batched_render_equals_per_utterance(setup):
    """A render of B utterances (one bank call of B*F rows) equals B
    separate renders."""
    _, tc, _, _, _ = setup
    f0, env, ap, _, noise = _controls(tc, 3, 12, 7)
    both, carry = t_syn.synthesize(t32(f0), t32(env), t32(ap), t32(noise),
                                   tc.dsp)
    assert both.shape == (3, 12 * tc.dsp.hop)
    for b in range(3):
        one, c1 = t_syn.synthesize(t32(f0[b]), t32(env[b]), t32(ap[b]),
                                   t32(noise[b]), tc.dsp)
        torch.testing.assert_close(both[b], one, rtol=0, atol=1e-6)
        torch.testing.assert_close(carry.noise_tail[b], c1.noise_tail,
                                   rtol=0, atol=1e-6)
        assert float(carry.phase[b]) == pytest.approx(float(c1.phase),
                                                      abs=1e-6)


def test_neural_vocode_matches_jax(setup):
    """The DDSP vocoder with perturbed (active) heads: waveform and carry
    within 2e-3 of the peak, the streamed == offline tolerance.  The JAX
    package integrates the phase with a triangular matmul, the port with
    cumsum: ~1e-6 rad apart, which harmonic 161 scales to ~2e-4 of the
    peak."""
    jc, tc, jp, tp, _ = setup
    f0, env, ap, mc, noise = _controls(jc, 2, 20, 1)
    jw, jcarry = jax.jit(jax.vmap(lambda p, *a: j_nv(
        p, *a, jc.vocoder_nn, jc.dsp), in_axes=(None, 0, 0, 0, 0, 0)))(
        jp["vocoder"], f0, env, ap, mc, noise)
    with torch.no_grad():
        tw, tcarry = neural_vocode(tp["vocoder"], t32(f0), t32(env),
                                   t32(ap), t32(mc), t32(noise),
                                   tc.vocoder_nn, tc.dsp)
    with torch.no_grad():
        plain = t_vc.params_to(tp, "cpu")["vocoder"]
        plain.harm_head.weight.zero_()
        plain.noise_head.weight.zero_()
        td, _ = neural_vocode(plain, t32(f0), t32(env), t32(ap), t32(mc),
                              t32(noise), tc.vocoder_nn, tc.dsp)
    assert rel_to_peak(td.numpy(), tw.numpy()) > 1e-2   # heads are active
    assert rel_to_peak(tw.numpy(), jw) < 2e-3
    assert rel_to_peak(tcarry.noise_tail.numpy(), jcarry.noise_tail) < 2e-3
    np.testing.assert_allclose(tcarry.phase.numpy(), jcarry.phase,
                               rtol=0, atol=1e-4)


def test_waveform_vocode_matches_jax(setup):
    """The wave decoder, run as two chunks so the second starts from a
    carry with live fractional track phases: both chunks' waveforms within
    2e-3 of the peak (see the DDSP test), ``frac_out`` within 1e-4 rad."""
    jc, tc, jp, tp, _ = setup
    f0, env, ap, mc, noise = _controls(jc, 1, 24, 2)
    f0[0, :] = np.where(f0[0] > 0, f0[0], 150.0)        # no phase resets
    cuts = ((0, 12), (12, 24))
    jcarry, tcarry = None, None
    j_step = jax.jit(j_wv, static_argnames=("wd_cfg", "dsp_cfg"))
    for lo, hi in cuts:
        rows = slice(lo, hi + 1)
        jw, jcarry = j_step(jp["vocoder_wave"], f0[0, rows], env[0, rows],
                            ap[0, rows], mc[0, rows], noise[0, lo:hi],
                            wd_cfg=jc.vocoder_wave, dsp_cfg=jc.dsp,
                            carry=jcarry)
        with torch.no_grad():
            tw, tcarry = waveform_vocode(
                tp["vocoder_wave"], t32(f0[0, rows]), t32(env[0, rows]),
                t32(ap[0, rows]), t32(mc[0, rows]), t32(noise[0, lo:hi]),
                tc.vocoder_wave, tc.dsp, tcarry)
        assert rel_to_peak(tw.numpy(), jw) < 2e-3
        np.testing.assert_allclose(tcarry.frac_phase.numpy(),
                                   np.asarray(jcarry.frac_phase), rtol=0,
                                   atol=1e-4)
        assert rel_to_peak(tcarry.res_tail.numpy(), jcarry.res_tail) < 2e-3
    assert np.abs(np.asarray(jcarry.frac_phase)).max() > 0.1


@pytest.mark.parametrize("T", [16, 15])
def test_discriminator_matches_jax(T):
    """flax's stride-2 SAME padding: (1, 2) for even T, (2, 2) for odd T;
    logits within 1e-5 of their peak."""
    jc, tc = training_configs()
    net, jd = j_disc.init_discriminator(jax.random.key(3),
                                        jc.super_resolution, jc.dsp)
    disc = t_disc.EnvelopeDiscriminator(tc.dsp.spec_bins)
    t_vc.load_flax(disc, j_vc.flatten_params(jd))
    logE = np.random.default_rng(T).uniform(
        -12, 0, (2, T, jc.dsp.spec_bins)).astype(np.float32)
    ref = np.asarray(net.apply(jd, jnp.asarray(logE)))
    with torch.no_grad():
        out = disc(t32(logE)).numpy()
    assert out.shape == ref.shape == (2, -(-T // 8))
    assert rel_to_peak(out, ref) < 1e-5


def test_hinge_losses_match_jax():
    rng = np.random.default_rng(4)
    real, fake = (rng.standard_normal((3, 5)).astype(np.float32) * 2
                  for _ in range(2))
    np.testing.assert_allclose(
        float(t_disc.d_hinge_loss(t32(real), t32(fake))),
        float(j_disc.d_hinge_loss(jnp.asarray(real), jnp.asarray(fake))),
        rtol=1e-6)
    np.testing.assert_allclose(float(t_disc.g_hinge_loss(t32(fake))),
                               float(j_disc.g_hinge_loss(jnp.asarray(fake))),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["mc_l1", "log_env_l2", "f0_l2",
                                  "multi_resolution_stft"])
def test_losses_match_jax(name):
    """Each loss within 1e-5 relative (float32 reductions)."""
    rng = np.random.default_rng(5)
    if name == "multi_resolution_stft":
        a = rng.standard_normal((2, 2400)).astype(np.float32) * 0.3
        b = (a + 0.1 * rng.standard_normal((2, 2400))).astype(np.float32)
    elif name == "f0_l2":
        a, b = (np.where(rng.uniform(0, 1, (2, 30)) > 0.3,
                         rng.uniform(80, 300, (2, 30)), 0.0
                         ).astype(np.float32) for _ in range(2))
    else:
        a, b = (np.exp(rng.uniform(-8, 1, (2, 30, 8))).astype(np.float32)
                for _ in range(2))
    ref = float(getattr(j_losses, name)(jnp.asarray(a), jnp.asarray(b)))
    out = float(getattr(t_losses, name)(t32(a), t32(b)))
    assert out == pytest.approx(ref, rel=1e-5)


def test_params_round_trip_all_subtrees(setup, tmp_path):
    """JAX flat -> port -> JAX flat is exact for all five subtrees, and the
    port's .npz loads strictly in the JAX package."""
    jc, tc, jp, tp, flat = setup
    back = t_vc.params_to_jax(tp)
    assert set(back) == set(flat)
    assert {k.split("/")[0] for k in back} == {
        "stage1", "stage2", "vocoder", "vocoder_wave", "f0_stats"}
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    path = tmp_path / "p.npz"
    t_vc.save_params_npz(tp, str(path))
    loaded = j_vc.load_params(j_vc.init_params(jax.random.key(5), jc),
                              str(path))
    for k, v in j_vc.flatten_params(loaded).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    with pytest.raises(ValueError):
        t_vc.save_params_npz(tp, str(tmp_path / "p.msgpack"))


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def test_loss_fn_and_grads_match_jax(setup, jbatch):
    """All five metrics within 1e-4 relative and every subtree's gradient
    within 2e-3 of its peak, against jax.value_and_grad(loss_fn) on the
    same batch.  The STFT terms' log magnitudes amplify float32 summation
    order in near-empty bins, hence the looser gradient bound."""
    jc, tc, jp, tp, _ = setup
    (_, jm), jg = jax.jit(jax.value_and_grad(j_ts.loss_fn, has_aux=True),
                          static_argnums=2)(jp, jbatch, jc)
    params = t_vc.params_trainable(tp, "cpu")
    tm, tg = t_ts.loss_and_grads(params, _port_batch(jbatch), tc)
    for k in ("loss", "mc", "env", "stft", "wave"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    jflat = j_vc.flatten_params(jg)
    tflat = _flat_grads(params, tg)
    for stage in ("stage1", "stage2", "vocoder", "vocoder_wave"):
        names = [n for n in jflat if n.startswith(stage + "/")]
        peak = max(np.abs(jflat[n]).max() for n in names)
        assert peak > 0, stage
        err = max(np.abs(tflat[n] - jflat[n]).max() for n in names)
        assert err / peak < 2e-3, (stage, err / peak)
    for n in t_vc.F0_STAT_NAMES:
        assert tflat[f"f0_stats/{n}"] == 0 == jflat[f"f0_stats/{n}"]


@pytest.mark.parametrize("lr", [1e-4, 0.1])
def test_optimizer_step_matches_optax(setup, lr):
    """Two clip_per_stage + AdamW steps from identical gradients against
    optax: stage1's gradients are large enough to clip, the others are
    not; f0_stats (zero gradient) only decays.  At the default lr 1e-4
    every leaf agrees to 1e-6.  At lr 0.1, where f0_stats' decay is
    visible in float32, f0_stats agree to 1e-6 and the other leaves' moves
    to 1e-4 of the largest (optax computes Adam's bias corrections in
    float32, where 1 - 0.999 is 1.3e-5 off)."""
    jc, tc, jp, tp, flat = setup
    rng = np.random.default_rng(6)
    scale = {"stage1": 10.0, "stage2": 1e-3, "vocoder": 1e-2,
             "vocoder_wave": 1e-3, "f0_stats": 0.0}
    opt = j_ts.make_optimizer(lr)
    update = jax.jit(opt.update)
    jstate = opt.init(jp)
    state = t_ts.init_train_state(tp, "cpu", lr=lr)
    j_params = jp
    for _ in range(2):
        g_flat = {k: (scale[k.split("/")[0]]
                      * rng.standard_normal(v.shape)).astype(np.float32)
                  for k, v in flat.items()}
        updates, jstate = update(j_vc.unflatten_params(jp, g_flat), jstate,
                                 j_params)
        j_params = jax.tree.map(jnp.add, j_params, updates)
        t_ts.apply_gradients(state.opt, state.params,
                             _port_grads(state.params, g_flat))
    ref = j_vc.flatten_params(j_params)
    out = t_vc.params_to_jax(state.params)
    for k, v in ref.items():
        if lr < 1e-3 or k.startswith("f0_stats/"):
            np.testing.assert_allclose(out[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            moved = np.abs(v - flat[k]).max()
            assert np.abs(out[k] - v).max() <= 1e-4 * moved + 1e-7, k
    if lr > 1e-3:
        assert out["f0_stats/src_mean"] != flat["f0_stats/src_mean"]


def test_gan_step_updates_both_and_decreases_d_loss(setup):
    """The port's counterpart of tests/test_training.py's GAN test, plus
    the EMA relation e' = 0.99 e + 0.01 p'."""
    _, tc, _, _, _ = setup
    params = t_vc.init_params(tc, torch.Generator().manual_seed(0))
    disc = t_disc.init_discriminator(tc.super_resolution, tc.dsp,
                                     torch.Generator().manual_seed(1))
    state = t_ts.init_gan_train_state(params, disc, "cpu")
    step = t_ts.make_gan_train_step(tc, adv_weight=0.05)
    batch = make_batch(tc, 2, seconds=0.1, seed=0, device="cpu")
    d0 = {k: v.detach().clone() for k, v in state.d_params.state_dict().items()}
    g0 = t_vc.params_to_jax(state.params)
    d_losses = []
    for _ in range(4):
        ema_before = t_vc.params_to_jax(state.ema_params)
        state, m = step(state, batch)
        d_losses.append(float(m["d_loss"]))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["adv"]))
    after = t_vc.params_to_jax(state.params)
    ema = t_vc.params_to_jax(state.ema_params)
    for k in ("stage1/params/head/kernel", "vocoder/params/stem/kernel"):
        np.testing.assert_allclose(ema[k], 0.99 * ema_before[k]
                                   + 0.01 * after[k], rtol=0, atol=1e-7)
    assert any(not torch.equal(v, state.d_params.state_dict()[k])
               for k, v in d0.items())
    for stage in ("stage1", "stage2"):
        assert any(not np.array_equal(g0[k], after[k]) for k in g0
                   if k.startswith(stage + "/"))
    assert d_losses[-1] < d_losses[0]
    assert state.step == 4


def test_gan_step_matches_jax(setup, jbatch):
    """One GAN step from the same generator and discriminator weights on
    the same batch: d_loss, adv and the joint losses within 1e-4
    relative."""
    jc, tc, jp, tp, _ = setup
    _, jd = j_disc.init_discriminator(jax.random.key(1),
                                      jc.super_resolution, jc.dsp)
    jstate = j_ts.init_gan_train_state(jp, jd)
    _, jm = jax.jit(j_ts.make_gan_train_step(jc, adv_weight=0.05))(
        jstate, jbatch)
    disc = t_disc.EnvelopeDiscriminator(tc.dsp.spec_bins)
    t_vc.load_flax(disc, j_vc.flatten_params(jd))
    state = t_ts.init_gan_train_state(tp, disc, "cpu")
    _, tm = t_ts.make_gan_train_step(tc, adv_weight=0.05)(
        state, _port_batch(jbatch))
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k


def test_make_batch_matches_jax(setup, jbatch):
    """Waveforms and noise bit-equal (one numpy generator, the same draw
    order); the analysed features agree with the JAX analysis."""
    _, tc, _, _, _ = setup
    tb = make_batch(tc, 2, seconds=0.1, seed=0, device="cpu")
    np.testing.assert_array_equal(tb.wave_voc.numpy(),
                                  np.asarray(jbatch.wave_voc))
    np.testing.assert_array_equal(tb.noise.numpy(), np.asarray(jbatch.noise))
    for k in ("f0_src", "f0_tgt"):
        a, b = getattr(tb, k).numpy(), np.asarray(getattr(jbatch, k))
        np.testing.assert_array_equal(a > 0, b > 0, err_msg=k)
        np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=k)
    for k in ("mc_src", "mc_tgt", "ap_src", "ap_voc"):
        assert rel_to_peak(getattr(tb, k).numpy(),
                           getattr(jbatch, k)) < 2e-3, k
    assert np.abs(np.log(tb.env_tgt.numpy())
                  - np.log(np.asarray(jbatch.env_tgt))).max() < 2e-2


def test_checkpoint_roundtrip_and_retention(setup, tmp_path):
    """The port's counterpart of tests/test_training.py's checkpoint test,
    with the optimizer's state restored too."""
    _, tc, _, tp, _ = setup
    state = t_ts.init_train_state(tp, "cpu")
    grads = {k: [torch.full_like(p, 0.1) for p in ps]
             for k, ps in t_vc.param_leaves(state.params).items()}
    t_ts.apply_gradients(state.opt, state.params, grads)
    template = t_ts.init_train_state(
        t_vc.init_params(tc, torch.Generator().manual_seed(9)), "cpu")
    for s in (10, 20, 30, 40):
        state.step = s
        t_ckpt.save_checkpoint(tmp_path, state, s, keep=2)
    kept = sorted(p.name for p in tmp_path.glob("ckpt_*.pt"))
    assert kept == ["ckpt_30.pt", "ckpt_40.pt"]
    assert t_ckpt.latest_checkpoint(tmp_path).name == "ckpt_40.pt"

    restored, step = t_ckpt.restore_checkpoint(tmp_path, template)
    assert step == 40 and restored.step == 40
    a, b = t_vc.params_to_jax(state.params), t_vc.params_to_jax(
        restored.params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    p0 = state.params["stage1"].stem.weight
    q0 = restored.params["stage1"].stem.weight
    torch.testing.assert_close(restored.opt.state[q0]["exp_avg"],
                               state.opt.state[p0]["exp_avg"])

    empty = tmp_path / "empty"
    empty.mkdir()
    same, step0 = t_ckpt.restore_checkpoint(empty, template)
    assert step0 == 0 and same is template


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", [[], ["--gan"]],
                         ids=["joint", "gan"])
def test_cli_train_synthetic_writes_npz_jax_loads(setup, tmp_path, objective,
                                                  capsys):
    jc, tc, _, _, _ = setup
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    out = tmp_path / "params.npz"
    t_cli.main(["--synthetic", "--steps", "2", "--batch_size", "2",
                "--crop_frames", "20", "--device", "cpu", "--log_every",
                "1", "--config_path", str(cfg_path), "--ckpt_dir",
                str(tmp_path / "ck"), "--export_params", str(out),
                *objective])
    log = capsys.readouterr().out
    assert "step 2/2" in log and "inference params" in log
    assert (tmp_path / "ck" / "ckpt_2.pt").exists()
    loaded = j_vc.load_params(j_vc.init_params(jax.random.key(0), jc),
                              str(out))
    flat = j_vc.flatten_params(loaded)
    # two steps moved the zero-initialised heads
    for k in ("stage1/params/head/kernel",
              "vocoder/params/harm_head/kernel",
              "vocoder_wave/params/comb_head/kernel"):
        assert np.abs(flat[k]).max() > 0, k
    port = t_vc.load_params_npz(str(out), tc)
    for k, v in t_vc.params_to_jax(port).items():
        np.testing.assert_array_equal(v, flat[k])


LAUNCH_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID")


@pytest.mark.parametrize("argv,names", [
    (["--synthetic", "--finetune_converted", "5"], "--prepared_dir"),
    (["--synthetic", "--model_parallel", "2"],
     "1 ranks not divisible by model_parallel=2"),
    (["--synthetic", "--coordinator_address", "127.0.0.1:29500",
      "--num_processes", "3", "--process_id", "0", "--model_parallel", "2"],
     "3 ranks not divisible by model_parallel=2"),
    (["--steps", "2"], "--prepared_dir or --synthetic"),
    (["--synthetic", "--export_params", "p.msgpack"], ".npz"),
])
def test_cli_rejects_what_is_not_ported_right_after_parsing(argv, names,
                                                            capsys,
                                                            monkeypatch):
    """Refused by the parser, before any model is built, a process group
    joined or a device touched: a bad combination names what it lacks, a
    --model_parallel that does not divide the ranks the mesh's error."""
    def no_init(*a, **k):
        raise AssertionError("reached the model set-up")
    monkeypatch.setattr(t_cli, "init_params", no_init)
    monkeypatch.setattr(t_cli, "init_multihost", no_init)
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert exc.value.code == 2
    assert names in capsys.readouterr().err


@pytest.mark.parametrize("argv,env,world", [
    (["--synthetic", "--coordinator_address", "127.0.0.1:29500",
      "--num_processes", "2", "--process_id", "1"], {}, 2),
    (["--synthetic", "--coordinator_address", "127.0.0.1:29500",
      "--num_processes", "4", "--process_id", "3", "--model_parallel", "2"],
     {}, 4),
    (["--synthetic", "--model_parallel", "2"],
     {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:29500", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "0"}, 2),
    (["--synthetic", "--num_processes", "1", "--process_id", "0",
      "--backend", "gloo"], {}, 1),
])
def test_cli_accepts_the_multi_process_flags_at_parse_time(argv, env, world,
                                                           monkeypatch):
    """The four launch flags (or the JAX package's environment names)
    parse, with a --model_parallel that divides the ranks they name (the
    run itself is tests/test_torch_multihost_train.py's)."""
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = t_cli.parse_args(argv)
    assert t_cli.launch_world(args) == world
    assert world % args.model_parallel == 0


@pytest.mark.parametrize("argv", [
    ["--prepared_dir", "corpus/"],
    ["--prepared_dir", "corpus/", "--cache_utterances", "4"],
    ["--prepared_dir", "corpus/", "--finetune_converted", "5",
     "--finetune_lr", "1e-3"],
    ["--synthetic", "--cache_utterances", "4"],
])
def test_cli_accepts_the_corpus_flags_at_parse_time(argv):
    """The corpus path's flags parse (the run itself is
    tests/test_torch_full_chain.py's)."""
    args = t_cli.parse_args(argv)
    assert args.prepared_dir == ("corpus/" if "--prepared_dir" in argv
                                 else None)
    if "--finetune_lr" in argv:
        assert (args.finetune_converted, args.finetune_lr) == (5, 1e-3)
