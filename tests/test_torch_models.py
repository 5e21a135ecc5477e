"""The port's model stages against the JAX package's, with the same
perturbed weights carried across by params_from_jax, and the strict
weight loader."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_yukarin_tpu.models import acoustic as j_ac
from realtime_yukarin_tpu.models import super_resolution as j_sr
from realtime_yukarin_tpu.models import voice_changer as j_vc
from realtime_yukarin_tpu_torch.models import acoustic as t_ac
from realtime_yukarin_tpu_torch.models import super_resolution as t_sr
from realtime_yukarin_tpu_torch.models import voice_changer as t_vc

from torch_parity import configs, perturbed_params, t32


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs()
    jp, tp, flat = perturbed_params(jc, tc)
    return jc, tc, jp, tp, flat


def _features(cfg, T, seed):
    rng = np.random.default_rng(seed)
    mc = rng.standard_normal((T, cfg.dsp.mc_dim)).astype(np.float32)
    f0 = np.where(rng.uniform(0, 1, T) > 0.3,
                  rng.uniform(80, 300, T), 0.0).astype(np.float32)
    return mc, f0


def test_init_params_shapes_match_jax(setup):
    jc, tc, _, _, _ = setup
    flat = j_vc.flatten_params(j_vc.init_params(jax.random.key(0), jc))
    expected = t_vc._expected(tc)
    assert set(expected) == set(flat)          # all five subtrees carried
    for name, shape in expected.items():
        assert tuple(flat[name].shape) == shape, name
    fresh = t_vc.init_params(tc, torch.Generator().manual_seed(0))
    assert not fresh["stage1"].head.weight.any()
    assert not fresh["stage2"].head.weight.any()
    assert not fresh["vocoder"].harm_head.weight.any()
    assert not fresh["vocoder_wave"].comb_head.weight.any()
    assert fresh["stage1"].blocks[0].conv.weight.std() > 0
    assert fresh["vocoder_wave"].convs[0].weight.std() > 0
    np.testing.assert_array_equal(
        fresh["vocoder_wave"].frac_ratios.numpy(),
        flat["vocoder_wave/params/frac_ratios"])


def test_stage1_streamed_matches_jax(setup):
    jc, tc, jp, tp, _ = setup
    mc_row, f0_row = _features(jc, 1, 0)
    j_caches, j_res = j_ac.stage1_cache_init(
        jp["stage1"], jnp.asarray(mc_row[0]), jnp.asarray(f0_row[0]),
        jc.acoustic)
    t_caches, t_res = t_ac.stage1_cache_init(
        tp["stage1"], t32(mc_row[0]), t32(f0_row[0]), tc.acoustic)
    np.testing.assert_allclose(t_res.numpy(), np.asarray(j_res), rtol=0,
                               atol=1e-5)
    for step in range(3):
        mc, f0 = _features(jc, 20, step + 1)
        j_out, j_caches = j_ac.convert_mc_streamed(
            jp["stage1"], jnp.asarray(mc), jnp.asarray(f0), j_caches,
            jc.acoustic)
        t_out, t_caches = t_ac.convert_mc_streamed(
            tp["stage1"], t32(mc), t32(f0), t_caches, tc.acoustic)
        assert np.abs(np.asarray(j_out)).max() > 1e-2   # heads are active
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   rtol=0, atol=1e-5)
        for a, b in zip(t_caches, j_caches):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


def test_stage1_full_forward_matches_jax_and_streamed(setup):
    """The SAME-padded full forward equals JAX's convert_mc, and its
    interior equals the streamed forward (the caches' contract)."""
    jc, tc, jp, tp, _ = setup
    mc, f0 = _features(jc, 60, 9)
    j_full = np.asarray(j_ac.convert_mc(jp["stage1"], jnp.asarray(mc),
                                        jnp.asarray(f0), jc.acoustic,
                                        jc.dsp))
    x = t_ac.acoustic_inputs(t32(mc), t32(f0), tc.acoustic)
    t_full = t32(mc) + tp["stage1"](x, torch.float32)
    np.testing.assert_allclose(t_full.numpy(), j_full, rtol=0, atol=1e-5)
    # streamed from a cache seeded by the first k-1 stem outputs
    c = tc.acoustic.context_frames
    k = tc.acoustic.kernel_size
    caches, _ = t_ac.stage1_cache_init(tp["stage1"], t32(mc[0]), t32(f0[0]),
                                       tc.acoustic)
    res, _ = t_ac.convert_mc_streamed(tp["stage1"], t32(mc), t32(f0),
                                      caches, tc.acoustic)
    # output frame i of the streamed run is input frame i - c; compare the
    # interior where neither run sees its own edge treatment
    lo = 2 * c + k
    np.testing.assert_allclose(res[lo:].numpy() + mc[lo - c: 60 - c],
                               t_full[lo - c: 60 - c].numpy(), rtol=0,
                               atol=1e-5)


def test_refine_envelope_matches_jax(setup):
    jc, tc, jp, tp, _ = setup
    rng = np.random.default_rng(5)
    env = np.exp(rng.uniform(-12, 2, (30, jc.dsp.spec_bins))
                 ).astype(np.float32)
    j_out = np.asarray(j_sr.refine_envelope(jp["stage2"], jnp.asarray(env),
                                            jc.super_resolution, jc.dsp))
    t_out = t_sr.refine_envelope(tp["stage2"], t32(env),
                                 tc.super_resolution, tc.dsp).numpy()
    assert np.abs(np.log(j_out) - np.log(env)).max() > 1e-2
    np.testing.assert_allclose(np.log(t_out), np.log(j_out), rtol=0,
                               atol=1e-4)


def test_convert_f0_stats_matches_jax():
    f0 = np.array([0.0, 80.0, 160.0, 311.5, 0.0], np.float32)
    stats = {"src_mean": np.log(150.0), "src_std": 0.2,
             "tgt_mean": np.log(220.0), "tgt_std": 0.3}
    j = j_vc.convert_f0_stats(jnp.asarray(f0),
                              {k: jnp.float32(v) for k, v in stats.items()})
    t = t_vc.convert_f0_stats(t32(f0), {k: torch.tensor(v, dtype=torch.float32)
                                        for k, v in stats.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_compute_dtype_matches_config():
    from realtime_yukarin_tpu_torch.config import Config
    assert t_vc.compute_dtype(Config()) is torch.bfloat16
    assert t_vc.compute_dtype(Config(compute_dtype="float32")) \
        is torch.float32


def test_strict_loader(setup, tmp_path):
    jc, tc, jp, _, flat = setup
    path = tmp_path / "params.npz"
    j_vc.save_params(jp, str(path))
    params = t_vc.load_params_npz(str(path), tc)
    w = params["stage1"].blocks[0].conv.weight
    np.testing.assert_array_equal(
        w.numpy(), np.transpose(flat["stage1/params/block_0/conv/kernel"],
                                (2, 1, 0)))
    np.testing.assert_array_equal(
        params["vocoder"].noise_head.weight.numpy(),
        np.transpose(flat["vocoder/params/noise_head/kernel"], (2, 1, 0)))
    missing = dict(flat)
    del missing["stage2/params/head/bias"]
    with pytest.raises(ValueError, match="missing"):
        t_vc.params_from_jax(missing, tc)
    extra = dict(flat, **{"stage1/params/block_9/conv/kernel":
                          np.zeros((5, 32, 64), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        t_vc.params_from_jax(extra, tc)
    bad = dict(flat, **{"stage2/params/freq_in/kernel":
                        np.zeros((513, 64), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        t_vc.params_from_jax(bad, tc)
