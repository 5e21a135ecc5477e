"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode and their XLA
references, at the tolerances of tests/test_pallas.py, and the harmonic
bank's autograd Function on the CPU.  A CPU tensor never launches a kernel:
the launch counts stay 0."""

import re

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
from realtime_yukarin_tpu_torch.dsp import primitives as prim
from realtime_yukarin_tpu_torch.ops import analysis, cuda, dft
from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
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


def _power_inputs(n, R=24, seed=5):
    frames = (np.random.default_rng(seed).standard_normal((R, n)) * 0.3
              ).astype(np.float32)
    ref_x = np.asarray(j_power_xla(jnp.asarray(frames), n))
    ref_k = np.asarray(j_power_fused(jnp.asarray(frames), n, interpret=True))
    return frames, ref_x, ref_k


def _power_from_basis(frames, n):
    """The power-spectrum kernel's arithmetic on the CPU: frames (zero-padded
    to the basis depth) against the windowed, stacked, tile-contiguous
    basis, then de-interleaved into re and im and squared."""
    basis = torch.as_tensor(analysis.power_basis(n), dtype=torch.float32)
    tiles, depth, _ = basis.shape
    flat = basis[:, :, :2 * analysis.TILE_BINS].permute(1, 0, 2).reshape(
        depth, tiles * 2 * analysis.TILE_BINS)
    x = torch.nn.functional.pad(t32(frames), (0, depth - n))
    y = x @ flat
    K = n // 2 + 1
    re, im = y[:, 0::2][:, :K], y[:, 1::2][:, :K]
    return (re * re + im * im).numpy()


@pytest.mark.parametrize("n", [1022, 1024])
def test_power_basis_layout_gives_the_power_spectrum(n):
    """The kernel's one constant -- Hann folded into the cos/sin bases,
    bin j at stacked columns 2j / 2j+1, depth padded to 1024, tiles of 32
    bins stored contiguously with 8 zero columns -- multiplied by plain
    torch and de-interleaved: the plain version to 1e-6 of the peak, JAX's
    XLA reference and the interpret-mode Pallas kernel to 1e-4."""
    basis = analysis.power_basis(n)
    K = n // 2 + 1
    assert basis.shape == (-(-K // analysis.TILE_BINS), analysis.DEPTH,
                           analysis.BASIS_ROW)
    assert not basis[:, n:, :].any()
    assert not basis[:, :, 2 * analysis.TILE_BINS:].any()
    frames, ref_x, ref_k = _power_inputs(n)
    out = _power_from_basis(frames, n)
    plain = analysis.power_spectrum_plain(t32(frames), n).numpy()
    assert rel_to_peak(out, plain) < 1e-6
    assert rel_to_peak(out, ref_x) < 1e-4
    assert rel_to_peak(out, ref_k) < 1e-4


def _cepstrum_inputs(n, R=24, seed=3):
    cfg = DspConfig()
    K = n // 2 + 1
    rng = np.random.default_rng(seed)
    P = (rng.uniform(0, 1, (R, K)) ** 2 * 1e-2).astype(np.float32)
    lift = np.sinc(rng.uniform(80, 300, (R, 1)) * np.arange(K)
                   / cfg.sample_rate).astype(np.float32)
    db = cfg.envelope_floor_db
    ref_x = np.asarray(j_cepstrum_xla(jnp.asarray(P), jnp.asarray(lift), n,
                                      db))
    ref_k = np.asarray(j_cepstrum_fused(jnp.asarray(P), jnp.asarray(lift), n,
                                        db, interpret=True))
    return P, lift, db, ref_x, ref_k


def _cepstrum_from_basis(P, lift, n, db):
    """The envelope-cepstrum kernel's arithmetic on the CPU: the column-
    sliced D reassembled, and C = D / n, so all three products use D."""
    K = n // 2 + 1
    width = analysis.cepstrum_plan(len(P), K).width
    sl = torch.as_tensor(dft.sliced_cepstrum_basis(n, width, analysis.CLUSTER),
                         dtype=torch.float32)
    kp = sl.shape[1]
    D = sl.permute(1, 0, 2).reshape(kp, kp)
    pad = kp - K
    x = torch.nn.functional.pad(t32(P), (0, pad))
    lf = torch.nn.functional.pad(t32(lift), (0, pad))
    Y = (x @ D) * (1.0 / (2 * (K - 1))) * lf
    Ps = (Y @ D)[:, :K]
    floor = torch.clamp(Ps.amax(dim=1, keepdim=True) * 10.0 ** (db / 10.0),
                        min=prim.POWER_FLOOR)
    L = torch.nn.functional.pad(torch.log(torch.maximum(Ps, floor)),
                                (0, pad))
    return ((L @ D) * (1.0 / (2 * (K - 1))) * lf)[:, :K].numpy()


@pytest.mark.parametrize("n", [1022, 1024])
def test_sliced_cepstrum_basis_is_d_and_gives_the_chain(n):
    """The kernel's one constant reassembles to cepstrum_inverse_basis (D),
    cepstrum_basis is D / n, and the chain computed from it the kernel's
    way matches the plain version to 1e-6 of the peak and JAX's XLA
    reference and interpret-mode Pallas kernel to 1e-4."""
    K = n // 2 + 1
    width = analysis.cepstrum_plan(20, K).width
    sl = dft.sliced_cepstrum_basis(n, width, analysis.CLUSTER)
    kp = sl.shape[1]
    assert sl.shape == (analysis.CLUSTER, kp, width) and kp >= K
    D = sl.transpose(1, 0, 2).reshape(kp, kp)
    np.testing.assert_array_equal(D[:K, :K], dft.cepstrum_inverse_basis(n))
    assert not D[K:].any() and not D[:, K:].any()
    np.testing.assert_allclose(D[:K, :K] / n, dft.cepstrum_basis(n),
                               rtol=1e-15, atol=1e-18)
    P, lift, db, ref_x, ref_k = _cepstrum_inputs(n)
    out = _cepstrum_from_basis(P, lift, n, db)
    plain = analysis.envelope_cepstrum_plain(t32(P), t32(lift), n,
                                             db).numpy()
    assert rel_to_peak(out, plain) < 1e-6
    assert rel_to_peak(out, ref_x) < 1e-4
    assert rel_to_peak(out, ref_k) < 1e-4


def _covered_once(spans, total):
    count = np.zeros(total, int)
    for a, b in spans:
        assert 0 <= a < b <= total, (a, b, total)
        count[a:b] += 1
    return bool((count == 1).all())


def _folded_once(depth_spans, pairs, total):
    """The folded depth rows' spans cover the folded index range once, and
    the samples (or bins) the rows stand for, ``pairs(u)``, cover
    [0, total) once."""
    count = np.zeros(total, int)
    for a, b in depth_spans:
        for u in range(a, b):
            for t in pairs(u):
                count[t] += 1
    return bool((count == 1).all())


WIDE_ROWS = (analysis.POWER_WIDE_ROWS - 1, analysis.POWER_WIDE_ROWS,
             analysis.CEPSTRUM_WIDE_ROWS - 1, analysis.CEPSTRUM_WIDE_ROWS,
             2048, 2049, 10239, 10240)


@pytest.mark.parametrize("K", [512, 513])
@pytest.mark.parametrize("R", [1, 20, 21, 100, 800, 1280, 1281] +
                         list(WIDE_ROWS))
def test_kernel_plans_cover_every_row_bin_and_depth_once(R, K):
    """Both kernels' grids, as their plans lay them out, take every row,
    every bin (column) and every depth sample exactly once: the cluster
    designs directly; the wide designs through their folds (a folded depth
    row stands for samples t and n - t, split by parity of t for the power
    spectrum's base bins k, each of which also gives bin n/2 - k; for the
    cepstrum a and n/2 - a)."""
    n = 2 * (K - 1)
    half = n // 2
    power = analysis.power_plan(R, n)
    spans = power.spans(R, n)
    assert _covered_once(spans["rows"], R)
    if isinstance(power, analysis.WidePowerPlan):
        assert R >= analysis.POWER_WIDE_ROWS
        assert _covered_once(spans["bins"], half // 2 + 1)
        assert _folded_once(spans["bins"], lambda k: {k, half - k}, K)

        def samples(u):
            ts = [t for t in (2 * u, 2 * u + 1) if t <= half]
            return [s for t in ts for s in ({t, n - t} if 0 < t < half
                                            else {t})]
        assert _folded_once(spans["depth"], samples, n)
    else:
        assert R < analysis.POWER_WIDE_ROWS
        assert power.row_tile <= analysis.CLUSTER_ROWS
        assert _covered_once(spans["bins"], K)
        assert _covered_once(spans["depth"], n)
    cep = analysis.cepstrum_plan(R, K)
    spans = cep.spans(R, K)
    assert _covered_once(spans["rows"], R)
    assert _covered_once(spans["columns"], K)
    if isinstance(cep, analysis.WideCepstrumPlan):
        assert R >= analysis.CEPSTRUM_WIDE_ROWS
        assert analysis._wide_cepstrum_smem(K, cep.columns) <= \
            analysis.SMEM_BYTES
        assert 2 * cep.columns >= K
        assert _folded_once(spans["depth"],
                            lambda a: {a, half - a} if a <= half // 2
                            else set(), K)
    else:
        assert R < analysis.CEPSTRUM_WIDE_ROWS
        assert analysis._cepstrum_smem(cep.rows, cep.width) <= \
            analysis.SMEM_BYTES
        assert _covered_once(spans["depth"], K)


@pytest.mark.parametrize("n", [1022, 1024])
def test_plans_pick_the_cluster_design_below_the_crossover(n):
    """The design is the row count's alone: below ``POWER_WIDE_ROWS`` /
    ``CEPSTRUM_WIDE_ROWS`` rows the cluster design with the plan it always
    had (the single stream's R = 4 and 20 among them), from there the wide
    one; each cost formula counts the design its row count takes."""
    K = n // 2 + 1
    for R in (1, 4, 20, 100, analysis.POWER_WIDE_ROWS - 1):
        assert analysis.power_plan(R, n) == analysis.cluster_power_plan(R, n)
        assert isinstance(analysis.power_plan(R, n), analysis.PowerPlan)
        assert analysis.power_spectrum_cost(R, n)[0] == 4 * R * n * K
    for R in (analysis.POWER_WIDE_ROWS, 2048, 10240):
        assert analysis.power_plan(R, n) == analysis.WIDE_POWER_PLAN
        assert analysis.power_spectrum_cost(R, n)[0] == \
            2 * R * n * (n // 4 + 1)
    for R in (1, 4, 20, 100, analysis.CEPSTRUM_WIDE_ROWS - 1):
        assert analysis.cepstrum_plan(R, K) == \
            analysis.cluster_cepstrum_plan(R, K)
        assert isinstance(analysis.cepstrum_plan(R, K), analysis.CepstrumPlan)
        assert analysis.envelope_cepstrum_cost(R, K)[0] == 6 * R * K * K
    for R in (analysis.CEPSTRUM_WIDE_ROWS, 2048, 10240):
        wide = analysis.cepstrum_plan(R, K)
        assert wide == analysis.wide_cepstrum_plan(K)
        assert isinstance(wide, analysis.WideCepstrumPlan)
        flops = analysis.envelope_cepstrum_cost(R, K)[0]
        assert 3 * R * K * K <= flops < 3 * R * K * (K + 4)


def _wide_power_from_basis(frames, n):
    """The wide power-spectrum kernel's arithmetic in float64: fold the
    frames (t with n - t), split by parity of t, multiply by the four
    parts of each base-bin tile, and form bins k and n/2 - k."""
    basis = analysis.wide_power_basis(n)
    tiles, depth, _ = basis.shape
    B = analysis.WIDE_BINS
    half = n // 2
    x = np.asarray(frames, np.float64)
    e = np.zeros((len(x), 2 * depth))
    o = np.zeros((len(x), 2 * depth))
    t = np.arange(1, half)
    e[:, : half + 1] = x[:, : half + 1]
    e[:, t] += x[:, n - t]
    o[:, t] = x[:, t] - x[:, n - t]
    parts = (e[:, 0::2], e[:, 1::2], o[:, 0::2], o[:, 1::2])
    sums = [np.concatenate([p @ basis[i, :, q * B:(q + 1) * B]
                            for i in range(tiles)], 1)
            for q, p in enumerate(parts)]
    ae, ao, be, bo = (v[:, : half // 2 + 1] for v in sums)
    P = np.zeros((len(x), half + 1))
    P[:, half - np.arange(half // 2 + 1)] = (ae - ao) ** 2 + (be - bo) ** 2
    P[:, : half // 2 + 1] = (ae + ao) ** 2 + (be + bo) ** 2
    return P


@pytest.mark.parametrize("n", [1022, 1024])
def test_wide_power_basis_layout_gives_the_power_spectrum(n):
    """The wide kernel's one constant -- the windowed rfft bases folded
    over the samples and over the bins, [tiles of 64 base bins][depth u]
    [w cos at 2u | w cos at 2u + 1 | w sin at 2u | w sin at 2u + 1] --
    used the kernel's way in float64: the plain version in float64 to
    1e-12 of the peak, JAX's XLA reference and the interpret-mode Pallas
    kernel to 1e-4."""
    basis = analysis.wide_power_basis(n)
    half = n // 2
    assert basis.shape == (-(-(half // 2 + 1) // analysis.WIDE_BINS),
                           -(-(half // 2 + 1) // analysis.WIDE_CHUNK)
                           * analysis.WIDE_CHUNK, 4 * analysis.WIDE_BINS)
    assert not basis[:, half // 2 + 1:].any()
    frames, ref_x, ref_k = _power_inputs(n)
    out = _wide_power_from_basis(frames, n)
    plain = analysis.power_spectrum_plain(
        torch.as_tensor(frames, dtype=torch.float64), n).numpy()
    assert rel_to_peak(out, plain) < 1e-12
    assert rel_to_peak(out, ref_x) < 1e-4
    assert rel_to_peak(out, ref_k) < 1e-4


def _wide_cepstrum_from_basis(P, lift, n, db):
    """The wide envelope-cepstrum kernel's arithmetic in float64: each of
    the three products folds its input (a with n/2 - a) into S, feeding
    the even output columns, and D, feeding the odd ones."""
    K = n // 2 + 1
    half = K - 1
    columns = analysis.wide_cepstrum_plan(K).columns
    F = analysis.wide_cepstrum_basis(n, columns)
    a = np.arange(half // 2 + 1)
    pair = a < half - a

    def product(Y):
        S = np.zeros((len(Y), len(F)))
        D = np.zeros((len(Y), len(F)))
        S[:, a] = Y[:, a] + np.where(pair, Y[:, half - a], 0.0)
        D[:, a] = np.where(pair, Y[:, a] - Y[:, half - a], 0.0)
        out = np.zeros((len(Y), K))
        out[:, 0::2] = (S @ F[:, :columns])[:, : (K + 1) // 2]
        out[:, 1::2] = (D @ F[:, columns:])[:, : K // 2]
        return out

    P, lift = np.asarray(P, np.float64), np.asarray(lift, np.float64)
    Ps = product(product(P) / n * lift)
    floor = np.maximum(Ps.max(1, keepdims=True) * 10.0 ** (db / 10.0),
                       prim.POWER_FLOOR)
    return product(np.log(np.maximum(Ps, floor))) / n * lift


@pytest.mark.parametrize("n", [1022, 1024])
def test_wide_cepstrum_basis_layout_gives_the_chain(n):
    """The wide kernel's one constant -- M = cepstrum_inverse_basis(n)
    folded about a = n/4, the even columns then the odd ones per folded
    depth row -- used the kernel's way in float64: the plain chain in
    float64 to 1e-12 of the peak, JAX's XLA reference and the
    interpret-mode Pallas kernel to 1e-4."""
    K = n // 2 + 1
    columns = analysis.wide_cepstrum_plan(K).columns
    F = analysis.wide_cepstrum_basis(n, columns)
    depth = n // 4 + 1
    assert F.shape == (-(-depth // analysis.WIDE_CHUNK)
                       * analysis.WIDE_CHUNK, 2 * columns)
    assert not F[depth:].any()
    M = dft.cepstrum_inverse_basis(n)
    np.testing.assert_array_equal(F[:depth, : (K + 1) // 2], M[:depth, 0::2])
    P, lift, db, ref_x, ref_k = _cepstrum_inputs(n)
    out = _wide_cepstrum_from_basis(P, lift, n, db)
    plain = analysis.envelope_cepstrum_plain(
        torch.as_tensor(P, dtype=torch.float64),
        torch.as_tensor(lift, dtype=torch.float64), n, db).numpy()
    assert rel_to_peak(out, plain) < 1e-12
    assert rel_to_peak(out, ref_x) < 1e-4
    assert rel_to_peak(out, ref_k) < 1e-4


def _constexprs(name):
    """{name: value} of the integer constants of csrc/<name>.cu."""
    src = (cuda.CSRC_DIR / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("n", [1022, 1024])
def test_power_plan_and_basis_are_in_the_kernels_layout(n):
    """What the wrapper hands csrc/power_spectrum.cu -- cluster size,
    padded depth, bins per tile, floats per basis row, rows per cluster --
    is what the kernel was built for (its launcher refuses anything else,
    so a drift shows here before it shows on the card)."""
    c = _constexprs("power_spectrum")
    assert (c["SLICES"], c["DEPTH"], c["TILE_BINS"], c["LD"],
            c["MAX_ROW_TILE"]) == (analysis.CLUSTER, analysis.DEPTH,
                                   analysis.TILE_BINS, analysis.BASIS_ROW,
                                   analysis.CLUSTER_ROWS)
    tiles = -(-(n // 2 + 1) // c["TILE_BINS"])
    assert analysis.power_basis(n).shape == (tiles, c["DEPTH"], c["LD"])
    for R in (1, 20, 21, 100, 800, 1280, 1281):
        plan = analysis.cluster_power_plan(R, n)
        assert 1 <= plan.row_tile <= c["MAX_ROW_TILE"]
        assert plan.depth_slice * c["SLICES"] == c["DEPTH"]


@pytest.mark.parametrize("K", [512, 513])
def test_cepstrum_plans_are_among_the_kernels_built(K):
    """Every (rows per thread, depth warps) the plan may choose is one that
    csrc/envelope_cepstrum.cu instantiates, its width is one the launcher
    takes, and the basis it uploads has the kernel's cluster size."""
    src = (cuda.CSRC_DIR / "envelope_cepstrum.cu").read_text()
    built = {(int(a), int(b)) for a, b in
             re.findall(r"rpt == (\d+) && wd == (\d+)", src)}
    assert built == set(analysis.ROW_GROUPS.values())
    assert _constexprs("envelope_cepstrum")["CL"] == analysis.CLUSTER
    for R in (1, 20, 21, 100, 800, 1280, 1281):
        plan = analysis.cluster_cepstrum_plan(R, K)
        assert (plan.rows_per_thread, plan.depth_warps) in built
        assert plan.rows == (8 // plan.depth_warps) * plan.rows_per_thread
        W = plan.width
        assert W % 8 == 0 and 64 <= W <= 128 and analysis.CLUSTER * W >= K
    sl = dft.sliced_cepstrum_basis(2 * (K - 1), W, analysis.CLUSTER)
    assert sl.shape == (analysis.CLUSTER, analysis.CLUSTER * W, W)


@pytest.mark.parametrize("n", [1022, 1024])
def test_wide_plans_and_bases_are_in_the_kernels_layout(n):
    """What the wrappers hand csrc/*_wide.cu -- rows and base bins per
    CTA, folded depth rows per chunk, the cepstrum's columns per warp of a
    group and the group sizes built -- is what the kernels were built for,
    and the bases have the layout the kernels read."""
    c = _constexprs("power_spectrum_wide")
    plan = analysis.WIDE_POWER_PLAN
    assert (c["BM"], c["BB"], c["DK"]) == tuple(plan)
    assert analysis.wide_power_basis(n).shape[2] == 4 * c["BB"]
    c = _constexprs("envelope_cepstrum_wide")
    K = n // 2 + 1
    wide = analysis.wide_cepstrum_plan(K)
    assert (c["BM"], c["DK"]) == (wide.rows, wide.chunk)
    assert c["CPW"] == analysis.WARP_COLUMNS
    src = (cuda.CSRC_DIR / "envelope_cepstrum_wide.cu").read_text()
    built = {int(w) for w in re.findall(r"columns == (\d+) \* CPW", src)}
    assert built == set(analysis.WIDE_CEP_WARPS)
    assert wide.columns // analysis.WARP_COLUMNS in built
    assert analysis.wide_cepstrum_basis(n, wide.columns).shape[1] == \
        2 * wide.columns


def test_plans_refuse_shapes_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        analysis.power_plan(20, 512)
    with pytest.raises(ValueError):
        analysis.power_plan(20, 1023)
    with pytest.raises(ValueError):
        analysis.cepstrum_plan(20, 700)


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


BANK_SHAPES = [(R, H, hop) for R in (1, 20, 21, 100, 800, 801)
               for H in (1, 31, 33, 128, 161) for hop in (20, 120, 200)]


def _check_slots(plan, R, H, hop, backward):
    """Every (row, harmonic) stored by exactly one (block, warp, lane);
    every (row, sample) read once by each segment of its row and written
    once by its segment-0 warps; segments on 32-group boundaries tiling
    [0, H); the block within the launchers' limits."""
    assert plan.samples_per_lane in hb.SAMPLES_PER_LANE
    assert 1 <= plan.warps <= hb.MAX_WARPS[backward]
    assert plan.segments <= max(1, H // hb.GROUP)
    assert (plan.sample_warps - 1) * plan.chunk < hop
    assert backward or plan.segments == 1
    assert not backward or plan.sample_warps == plan.rows_per_block == 1
    assert plan.smem_bytes(H, backward) <= hb.SMEM_BYTES
    bounds = hb.segment_bounds(H, plan.segments)
    assert all(h0 % hb.GROUP == 0 and h0 < h1 for h0, h1 in bounds)
    assert _covered_once(bounds, H)
    slots = plan.slots(R, H, hop)
    stored = sorted((r, h) for r, h, *_ in slots["harmonic"])
    assert stored == [(r, h) for r in range(R) for h in range(H)]
    assert len({s[2:] + (s[1] // hb.GROUP,) for s in slots["harmonic"]}) \
        == len(stored)
    reads = sorted((r, seg, n) for r, seg, n, *_ in slots["sample"])
    assert reads == [(r, seg, n) for r in range(R)
                     for seg in range(plan.segments) for n in range(hop)]
    assert len({s[3:] for s in slots["sample"]}) == len(reads)
    writes = sorted((r, n) for r, n, *_ in slots["write"])
    assert writes == [(r, n) for r in range(R) for n in range(hop)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("R,H,hop", BANK_SHAPES)
def test_bank_plan_covers_every_harmonic_and_sample_once(R, H, hop,
                                                         backward):
    """As the bank kernels lay the work out (bank_plan's tiling)."""
    _check_slots(hb.bank_plan(R, H, hop, backward=backward), R, H, hop,
                 backward)


SPLIT_PLANS = [(hb.BankPlan(1, 1, 4, 2), False),
               (hb.BankPlan(2, 1, 2, 4), False),
               (hb.BankPlan(4, 1, 1, 8), False),
               (hb.BankPlan(2, 5, 1, 1), True),
               (hb.BankPlan(4, 3, 1, 1), True)]


@pytest.mark.parametrize("plan,backward,R,hop", [
    (plan, backward, R, hop) for plan, backward in SPLIT_PLANS
    for R, hop in ((21, 120), (3, 200))
    if (plan.sample_warps - 1) * plan.chunk < hop])
def test_split_plans_cover_every_harmonic_and_sample_once(plan, backward, R,
                                                          hop):
    """Tilings bank_plan does not choose at these shapes but the launchers
    take, as the sweep in tools/torch_bank_ab.py launches them: the same
    coverage at H = 161."""
    _check_slots(plan, R, 161, hop, backward)


def test_bank_plans_at_the_main_paths_widths():
    """The tilings the sweep on the card chose: the forward gives each
    32-sample chunk of a streaming step's 20 rows its own warp and takes 4
    samples per lane at training's 800 rows; the backward splits a row's
    161 harmonics into 5 segments at 20 rows, 3 at 100, none at 800."""
    assert hb.bank_plan(20, 161, 120) == hb.BankPlan(1, 1, 4, 1)
    assert hb.bank_plan(100, 161, 120) == hb.BankPlan(1, 1, 4, 1)
    assert hb.bank_plan(800, 161, 120) == hb.BankPlan(4, 1, 1, 4)
    assert hb.bank_plan(1280, 161, 120) == hb.BankPlan(4, 1, 1, 4)
    assert [hb.bank_plan(R, 161, 120, backward=True).segments
            for R in (20, 100, 800)] == [5, 3, 1]
    assert hb.bank_plan(800, 161, 120, backward=True) == \
        hb.BankPlan(4, 1, 1, 1)


def test_bank_wrappers_refuse_shapes_the_kernels_do_not_take():
    """No harmonics or no samples: both plans and both wrappers raise, on
    the CPU too.  More harmonics than a block's shared memory holds: both
    plans raise (the wrappers plan on CUDA tensors only, so a CUDA call
    raises before it launches; the plain versions take any H)."""
    for R, H, hop in ((3, 0, 120), (3, 8, 0), (3, 20000, 120)):
        for backward in (False, True):
            with pytest.raises(ValueError):
                hb.bank_plan(R, H, hop, backward=backward)
        if H > 8:
            continue
        a = torch.zeros((R, H))
        phi = torch.zeros((R, hop))
        with pytest.raises(ValueError):
            harmonic_bank(a, a, phi, torch.zeros(hop))
        with pytest.raises(ValueError):
            harmonic_bank_bwd(a, a, phi, torch.zeros(hop), phi)


def test_bank_launchers_take_the_plan():
    """The ctypes signatures carry the plan's ints after (R, H, hop), as
    BankPlan.launch_args orders them, and the sources' constants are the
    plan's."""
    plan = hb.bank_plan(20, 161, 120)
    for k, backward, n_ptr in ((cuda.HARMONIC_BANK, False, 5),
                               (cuda.HARMONIC_BANK_BWD, True, 9)):
        n_int = 3 + len(plan.launch_args(backward))
        assert k.argtypes == (cuda._P,) * n_ptr + (cuda._I,) * n_int + \
            (cuda._P,)
        src = (cuda.CSRC_DIR / f"{k.name}.cu").read_text()
        built = {int(x) for x in re.findall(r"case (\d+):", src)}
        assert built == set(hb.SAMPLES_PER_LANE)
        c = _constexprs(k.name)
        assert (c["WARP"], c["MAX_WARPS"], c["N_CONST"], c["PAD"]) == (
            hb.WARP, hb.MAX_WARPS[backward], hb.N_CONST[backward],
            hb.CAP_PAD)
        if backward:
            assert c["GROUP"] == hb.GROUP
            assert hb.RED_FLOATS[True] == c["GROUP"] * (2 * c["WARP"] + 4)
