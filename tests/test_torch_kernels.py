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


@pytest.mark.parametrize("K", [512, 513])
@pytest.mark.parametrize("R", [1, 20, 21, 100, 800, 1280, 1281])
def test_kernel_plans_cover_every_row_bin_and_depth_once(R, K):
    """Both kernels' grids, as their plans lay them out, take every row,
    every bin (column) and every depth sample exactly once."""
    n = 2 * (K - 1)
    power = analysis.power_plan(R, n)
    assert power.row_tile <= analysis.CLUSTER_ROWS
    spans = power.spans(R, n)
    assert _covered_once(spans["rows"], R)
    assert _covered_once(spans["bins"], K)
    assert _covered_once(spans["depth"], n)
    cep = analysis.cepstrum_plan(R, K)
    assert analysis._cepstrum_smem(cep.rows, cep.width) <= \
        analysis.SMEM_BYTES
    spans = cep.spans(R, K)
    assert _covered_once(spans["rows"], R)
    assert _covered_once(spans["columns"], K)
    assert _covered_once(spans["depth"], K)


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
        plan = analysis.power_plan(R, n)
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
        plan = analysis.cepstrum_plan(R, K)
        assert (plan.rows_per_thread, plan.depth_warps) in built
        assert plan.rows == (8 // plan.depth_warps) * plan.rows_per_thread
        W = plan.width
        assert W % 8 == 0 and 64 <= W <= 128 and analysis.CLUSTER * W >= K
    sl = dft.sliced_cepstrum_basis(2 * (K - 1), W, analysis.CLUSTER)
    assert sl.shape == (analysis.CLUSTER, analysis.CLUSTER * W, W)


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
