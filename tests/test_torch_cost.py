"""The port's count of one batched step (``utils/cost.py``,
``BatchedServer.step_cost_analysis``, ``parallel/serving.py:
model_stage_flops``): closed forms of the learned stages at the default
width, linearity in the lanes, a count that leaves the server as it was,
the kernels counted by formula and not by their plain versions, and the
learned stages against XLA's cost model (the JAX package's and bench.py's
count) at the tiny width.

Conventions, as the module docstrings state them: the port counts 2 FLOP
per multiply-add of aten's matrix products and convolutions, a
convolution's taps on its zero padding included; XLA's cost model also
counts the elementwise ops (a GLU's sigmoid and product, bias adds, the
log and exp around SR) and leaves out the taps of a 'SAME' convolution
that fall on the padding.  So XLA's count of stage 1 (valid convolutions
over its caches) lies a little above the port's, and so does XLA's count
of SR once the port's count drops SR's padded taps."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_yukarin_tpu.models.acoustic import \
    convert_mc_streamed as j_convert_mc_streamed
from realtime_yukarin_tpu.models.acoustic import \
    stage1_cache_init as j_stage1_cache_init
from realtime_yukarin_tpu.models.super_resolution import \
    refine_envelope as j_refine_envelope
from realtime_yukarin_tpu.models.voice_changer import \
    compute_dtype as j_compute_dtype
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.voice_changer import init_params
from realtime_yukarin_tpu_torch.ops import analysis
from realtime_yukarin_tpu_torch.ops import harmonic_bank as hb
from realtime_yukarin_tpu_torch.parallel.serving import (BatchedServer,
                                                         model_stage_flops)
from realtime_yukarin_tpu_torch.streaming.state import tree_leaves
from realtime_yukarin_tpu_torch.utils import cost

from torch_parity import configs, perturbed_params

# stage 1 over the 20 fresh frames of one stream at the default width:
# stem 62 -> 256, six blocks of a k = 5 GLU conv 256 -> 512 and a 1 x 1
# projection, head 256 -> 60
STAGE1_DEFAULT = 20 * (2 * 62 * 256 + 6 * (2 * 5 * 256 * 512
                                           + 2 * 256 * 256) + 2 * 256 * 60)
# SR over the 9 + 20 frames it reads, 15,728,640 FLOPs a frame: in and out
# 512 x 512, four blocks of a k = 3 conv 512 -> 1024 and a 512 x 512 mix
SR_DEFAULT = 29 * (2 * 2 * 512 * 512 + 4 * (2 * 3 * 512 * 1024
                                            + 2 * 512 * 512))
XLA_OVER_PORT = 1.02          # XLA's elementwise FLOPs on top, at most


@pytest.fixture(scope="module")
def default_params():
    return init_params(Config(), torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def tiny():
    jc, tc = configs()
    jp, tp, _ = perturbed_params(jc, tc)
    return jc, tc, jp, tp


def test_model_stages_closed_form_and_linear(default_params):
    assert (STAGE1_DEFAULT, SR_DEFAULT) == (174_264_320, 456_130_560)
    one = model_stage_flops(BatchedServer(default_params, Config(),
                                          num_streams=1, device="cpu"))
    assert one == {"stage1": STAGE1_DEFAULT, "stage2": SR_DEFAULT,
                   "vocoder": 0}
    eight = BatchedServer(default_params, Config(), num_streams=8,
                          device="cpu")
    assert model_stage_flops(eight) == {k: 8 * v for k, v in one.items()}


def _schedule(server, ticks: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((ticks, server.num_streams,
                                       server.chunk_samples))
            ).astype(np.float32)


def _leaves(carry) -> list[torch.Tensor]:
    return [t.clone() for t in tree_leaves(carry)]


def test_count_leaves_the_server_as_it_was(tiny):
    _, tc, _, tp = tiny
    server = BatchedServer(tp, tc, num_streams=2, seed=3, device="cpu")
    fresh = BatchedServer(tp, tc, num_streams=2, seed=3, device="cpu")
    chunks = _schedule(server, 3)
    for c in chunks[:2]:
        np.testing.assert_array_equal(server.step(c), fresh.step(c))
    before = _leaves(server._carries)
    first = server.step_cost_analysis()
    assert server.step_cost_analysis() == first
    assert set(first) == {"flops", "bytes accessed"}
    assert all(isinstance(v, float) and v > 0 for v in first.values())
    for a, b in zip(before, _leaves(server._carries)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(server.step(chunks[2]),
                                  fresh.step(chunks[2]))


def test_count_refuses_a_capture(tiny, monkeypatch):
    _, tc, _, tp = tiny
    server = BatchedServer(tp, tc, num_streams=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        server.step_cost_analysis()


def _formula(k: cost.KernelCost, n: int) -> tuple[int, int]:
    if k.name == "power_spectrum":
        return analysis.power_spectrum_cost(k.shape[0], n)
    return {"envelope_cepstrum": analysis.envelope_cepstrum_cost,
            "harmonic_bank": hb.bank_forward_cost}[k.name](*k.shape)


def _plain_flops(k: cost.KernelCost, cfg) -> int:
    """The aten FLOPs of the kernel's plain version at the launch's
    shape, counted alone."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=g)

    n = cfg.dsp.fft_size
    with torch.no_grad(), cost.StepCount() as count:
        if k.name == "power_spectrum":
            analysis.power_spectrum_plain(rand(k.shape[0], n), n)
        elif k.name == "envelope_cepstrum":
            R, K = k.shape
            analysis.envelope_cepstrum_plain(rand(R, K), rand(R, K), n,
                                             cfg.dsp.envelope_floor_db)
        else:
            R, H, hop = k.shape
            hb.harmonic_bank_plain(rand(R, H), rand(R, H), rand(R, hop),
                                   rand(hop))
    return count.flops


def test_kernels_counted_by_formula_not_plain(default_params, monkeypatch):
    """Each kernel counts its formula once per launch; the plain versions'
    matrix products, which compute it on the CPU, are not in the total:
    with the wrappers' reports switched off the total holds exactly the
    plain versions' FLOPs in the formulas' place."""
    cfg = Config()
    server = BatchedServer(default_params, cfg, num_streams=1, device="cpu")
    on = server.count_step()
    assert sorted(k.name for k in on.kernels) == [
        "envelope_cepstrum", "harmonic_bank", "power_spectrum"]
    K = cfg.dsp.fft_size // 2 + 1
    for k in on.kernels:
        assert k.shape[0] == 20
        assert k.name == "harmonic_bank" or k.shape == (20, K)
        assert (k.flops, k.bytes) == _formula(k, cfg.dsp.fft_size)
    monkeypatch.setattr(cost, "kernel",
                        lambda *a, **kw: contextlib.nullcontext())
    off = server.count_step()
    assert off.kernels == []
    plain = [_plain_flops(k, cfg) for k in on.kernels]
    assert all(p > 0 for p in plain)
    assert (off.flops - sum(plain)
            == on.flops - sum(k.flops for k in on.kernels))


def _xla_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(dict(ca)["flops"])


def test_learned_stages_against_xla(tiny):
    """bench.py's count (XLA's cost model of the JAX stage-1 and SR
    functions at the step's shapes) against the port's at the tiny width:
    port <= XLA <= 1.02 x port, for SR after the port's padded taps."""
    jc, tc, jp, tp = tiny
    N = 2
    server = BatchedServer(tp, tc, num_streams=N, device="cpu")
    port = model_stage_flops(server)
    Fc = server._geo.chunk_frames
    dtype = j_compute_dtype(jc)
    acts, _ = j_stage1_cache_init(
        jp["stage1"], jnp.zeros((jc.dsp.mc_dim,), jnp.float32),
        jnp.zeros((), jnp.float32), jc.acoustic, dtype)
    acts_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), acts)

    def s1(mc, f0, acts_b):
        return jax.vmap(lambda m, f, a: j_convert_mc_streamed(
            jp["stage1"], m, f, a, jc.acoustic, dtype))(mc, f0, acts_b)

    xla1 = _xla_flops(s1, jnp.zeros((N, Fc, jc.dsp.mc_dim), jnp.float32),
                      jnp.zeros((N, Fc), jnp.float32), acts_b)
    L2 = server._geo.stage1_cache_frames + Fc
    xla2 = _xla_flops(
        lambda env: j_refine_envelope(jp["stage2"], env,
                                      jc.super_resolution, jc.dsp, dtype),
        jnp.zeros((N, L2, jc.dsp.spec_bins), jnp.float32))
    sr = tc.super_resolution
    pad = sr.kernel_size // 2
    # taps on the padding: pad (pad + 1) of them per conv and lane, each a
    # hidden -> 2 hidden product
    padded = N * sr.num_blocks * pad * (pad + 1) * 2 * sr.hidden * 2 * (
        sr.hidden)
    for name, p, x in (("stage1", port["stage1"], xla1),
                       ("stage2", port["stage2"] - padded, xla2)):
        assert p <= x <= XLA_OVER_PORT * p, (name, p, x)


@pytest.mark.parametrize("mode", ["ddsp", "wave"])
def test_neural_vocoders_add_model_flops(tiny, mode):
    _, tc, _, tp = tiny
    dsp = model_stage_flops(BatchedServer(tp, tc, num_streams=2,
                                          device="cpu"))
    got = model_stage_flops(BatchedServer(tp, tc, num_streams=2,
                                          vocoder_mode=mode, device="cpu"))
    assert dsp["vocoder"] == 0 and got["vocoder"] > 0
    assert sum(got.values()) > sum(dsp.values())
