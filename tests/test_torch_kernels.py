"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode and their XLA
references, at the tolerances of tests/test_pallas.py, and the harmonic
bank's autograd Function on the CPU.  A CPU tensor never launches a kernel:
the launch counts stay 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_yukarin_tpu.config import DspConfig
from realtime_yukarin_tpu.ops.pallas_analysis import (
    envelope_cepstrum_fused as j_cepstrum_fused,
    envelope_cepstrum_xla as j_cepstrum_xla,
    power_spectrum_fused as j_power_fused,
    power_spectrum_xla as j_power_xla)
import jax

from realtime_yukarin_tpu.ops.pallas_synth import (
    _harmonic_bank_bwd_impl as j_hb_bwd, harmonic_bank as j_hb,
    harmonic_bank_xla as j_hbx)
from realtime_yukarin_tpu_torch.ops import analysis, cuda
from realtime_yukarin_tpu_torch.ops.harmonic_bank import (
    harmonic_bank, harmonic_bank_bwd, harmonic_bank_bwd_plain,
    harmonic_bank_plain)

from torch_parity import rel_to_peak, t32


@pytest.fixture(autouse=True)
def _zero_counts():
    cuda.reset_counts()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS)


@pytest.mark.parametrize("H", [64, 161])
def test_harmonic_bank_matches_jax(H):
    rng = np.random.default_rng(0)
    R, hop = 12, 120
    al = rng.uniform(0, 0.1, (R, H)).astype(np.float32)
    ar = rng.uniform(0, 0.1, (R, H)).astype(np.float32)
    phi = (rng.uniform(0, 2 * np.pi, (R, 1))
           + np.cumsum(rng.uniform(0.02, 0.2, (R, hop)), axis=1)
           ).astype(np.float32)
    frac = ((np.arange(hop) + 1.0) / hop).astype(np.float32)
    frac_rows = jnp.asarray(np.tile(frac, (R, 1)))
    ref_x = np.asarray(j_hbx(jnp.asarray(al), jnp.asarray(ar),
                             jnp.asarray(phi), frac_rows))
    ref_k = np.asarray(j_hb(jnp.asarray(al), jnp.asarray(ar),
                            jnp.asarray(phi), frac_rows, interpret=True))
    out = harmonic_bank(t32(al), t32(ar), t32(phi), t32(frac)).numpy()
    assert out.shape == (R, hop)
    # tests/test_pallas.py: 1e-3 of the peak (the Chebyshev recurrence
    # and sin(h*phi) at h*phi ~ 5000 rad differ by float32 phase rounding)
    assert rel_to_peak(out, ref_x) < 1e-3
    assert rel_to_peak(out, ref_k) < 1e-3


def _bank_inputs(R, H, hop, seed):
    rng = np.random.default_rng(seed)
    al = rng.uniform(0, 0.1, (R, H)).astype(np.float32)
    ar = rng.uniform(0, 0.1, (R, H)).astype(np.float32)
    phi = np.cumsum(rng.uniform(0.02, 0.2, (R, hop)), 1).astype(np.float32)
    frac = ((np.arange(hop) + 1.0) / hop).astype(np.float32)
    g = rng.standard_normal((R, hop)).astype(np.float32)
    return al, ar, phi, frac, g


@pytest.mark.parametrize("H", [16, 161])
def test_harmonic_bank_bwd_plain_matches_jax(H):
    """Kernel 4's plain version against the Pallas backward in interpret
    mode and against the VJP of harmonic_bank_xla: atol 2e-4
    (tests/test_pallas.py) at H = 16; at H = 161 on each output divided by
    its peak, since d_phi reaches ~800 there and the recurrence's float32
    phase error is ~1e-5 of that."""
    al, ar, phi, frac, g = _bank_inputs(4, H, 64, 2)
    frac_rows = np.tile(frac, (4, 1))
    ref_k = j_hb_bwd(*map(jnp.asarray, (al, ar, phi, frac_rows, g)),
                     interpret=True)
    _, vjp = jax.vjp(j_hbx, *map(jnp.asarray, (al, ar, phi, frac_rows)))
    ref_x = vjp(jnp.asarray(g))
    out = harmonic_bank_bwd(t32(al), t32(ar), t32(phi), t32(frac), t32(g))
    for o, k, x in zip(out, ref_k, ref_x):
        o, k, x = o.numpy(), np.asarray(k), np.asarray(x)
        assert o.shape == k.shape
        scale = 1.0 if H == 16 else float(np.abs(x).max())
        assert np.abs(o - k).max() / scale < 2e-4
        assert np.abs(o - x).max() / scale < 2e-4


def test_harmonic_bank_function_grads_match_autograd_of_plain():
    """The autograd Function on CPU tensors (plain forward, plain
    backward) against autograd through harmonic_bank_plain, for all four
    inputs (frac's gradient summed over the rows that share it)."""
    al, ar, phi, frac, _ = _bank_inputs(5, 32, 64, 4)

    def grads(fn):
        xs = [t32(a).requires_grad_(True) for a in (al, ar, phi, frac)]
        y = fn(*xs)
        return y.detach(), torch.autograd.grad(torch.sin(y).sum(), xs)

    y_f, g_f = grads(harmonic_bank)
    y_p, g_p = grads(harmonic_bank_plain)
    torch.testing.assert_close(y_f, y_p, rtol=0, atol=1e-6)
    for a, b in zip(g_f, g_p):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) / max(1.0, float(b.abs().max())) \
            < 1e-5


def test_harmonic_bank_function_skips_unneeded_grads():
    al, ar, phi, frac, _ = _bank_inputs(3, 8, 16, 5)
    a = t32(al).requires_grad_(True)
    y = harmonic_bank(a, t32(ar), t32(phi), t32(frac))
    (ga,) = torch.autograd.grad(y.sum(), [a])
    d_al, _, _, _ = harmonic_bank_bwd_plain(
        t32(al), t32(ar), t32(phi), t32(frac), torch.ones(3, 16))
    torch.testing.assert_close(ga, d_al)


def test_power_spectrum_matches_jax():
    rng = np.random.default_rng(1)
    n = 1022
    frames = (rng.standard_normal((40, n)) * 0.3).astype(np.float32)
    ref_x = np.asarray(j_power_xla(jnp.asarray(frames), n))
    ref_k = np.asarray(j_power_fused(jnp.asarray(frames), n,
                                     interpret=True))
    out = analysis.power_spectrum_fused(t32(frames), n).numpy()
    assert out.shape == (40, n // 2 + 1)
    assert rel_to_peak(out, ref_x) < 1e-4
    assert rel_to_peak(out, ref_k) < 1e-4


def test_envelope_cepstrum_matches_jax():
    cfg = DspConfig()
    n = cfg.fft_size
    K = n // 2 + 1
    rng = np.random.default_rng(3)
    P = (rng.uniform(0, 1, (24, K)) ** 2 * 1e-2).astype(np.float32)
    f0 = rng.uniform(80, 300, 24)
    lift = np.sinc(f0[:, None] * np.arange(K)[None, :]
                   / cfg.sample_rate).astype(np.float32)
    db = cfg.envelope_floor_db
    ref_x = np.asarray(j_cepstrum_xla(jnp.asarray(P), jnp.asarray(lift), n,
                                      db))
    ref_k = np.asarray(j_cepstrum_fused(jnp.asarray(P), jnp.asarray(lift),
                                        n, db, interpret=True))
    out = analysis.envelope_cepstrum_fused(t32(P), t32(lift), n, db).numpy()
    assert rel_to_peak(out, ref_x) < 1e-4
    assert rel_to_peak(out, ref_k) < 1e-4


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((4, 1022))
    with pytest.raises(TypeError):
        analysis.power_spectrum_fused(x.double(), 1022)
    with pytest.raises(ValueError):
        analysis.power_spectrum_fused(x[:, :1000], 1022)
    with pytest.raises(ValueError):
        analysis.power_spectrum_fused(torch.zeros((1022, 4)).T, 1022)
    P = torch.zeros((4, 512))
    with pytest.raises(ValueError):
        analysis.envelope_cepstrum_fused(P, torch.zeros((4, 511)), 1022,
                                         -70.0)
    a = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        harmonic_bank(a, a, torch.zeros((3, 120)), torch.zeros((3, 120)))
    with pytest.raises(ValueError):
        harmonic_bank(a, torch.zeros((3, 9)), torch.zeros((3, 120)),
                      torch.zeros(120))
    with pytest.raises(ValueError):
        harmonic_bank_bwd(a, a, torch.zeros((3, 120)), torch.zeros(120),
                          torch.zeros((3, 119)))
    with pytest.raises(TypeError):
        harmonic_bank_bwd(a, a, torch.zeros((3, 120)), torch.zeros(120),
                          torch.zeros((3, 120), dtype=torch.float64))


def test_kernel_build_targets_hopper_without_fast_math():
    assert "arch=compute_90a,code=sm_90a" in cuda.NVCC_FLAGS
    assert not any("fast_math" in f for f in cuda.NVCC_FLAGS)
    for k in cuda.KERNELS:
        src = (cuda.PACKAGE_DIR.parent / k.source).read_text()
        assert f'extern "C" int {k.name}_forward' in src
        assert "Replaces:" in src and "Bound on an H100" in src
