"""The yardstick's arithmetic: the learned FLOPs the port's own count gives, and
shares of a roofline that reach 100% exactly when the time is the least
time, never above."""

import importlib.util

import pytest

from benchmark import formulas, harness, tracing
from benchmark.reference.config import Config
from benchmark.reference.streaming.state import StreamGeometry


def test_learned_flops_are_the_counted_ones():
    cfg = Config()
    geo = StreamGeometry.from_config(cfg, True, vocoder_mode="dsp")
    assert formulas.stage1_flops(cfg, geo.chunk_frames) == 174_264_320
    assert formulas.sr_flops(cfg, geo.stage1_cache_frames
                             + geo.chunk_frames) == 456_130_560
    assert formulas.serve_learned_flops(cfg, geo) == 630_394_880


def test_bank_costs_are_the_kernels_formulas():
    assert formulas.bank_forward_cost(800, 161, 120) == (
        6 * 800 * 120 * 161, 4 * (2 * 800 * 161 + 2 * 800 * 120 + 120))
    assert formulas.bank_backward_cost(800, 161, 120, phase=False)[0] == \
        6 * 800 * 120 * 161
    assert formulas.bank_backward_cost(800, 161, 120)[0] == \
        14 * 800 * 120 * 161


def _reader(name):
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _records(kernel: str, least_s: float, key: str, steps: int = 4,
             split: int = 1, slower: float = 1.0):
    """``steps`` steps, each running ``kernel`` for ``slower`` times its
    least time (in ``split`` launches)."""
    dev, host, t = [], [], 0.0
    us = least_s * 1e6 * slower
    for _ in range(steps):
        host.append(("host.step", t, t + split * us + 10))
        for j in range(split):
            dev.append((f"void {kernel}<8>(float const*)", t + 1 + j * us
                        / split, t + 1 + (j + 1) * us / split))
        t += split * us + 20
    return tracing.Records(device=dev, host=host, steps=steps, counters={},
                           info={key: least_s})


@pytest.mark.parametrize("name,kernel,key", [
    ("analysis_roofline.serve", "power_spectrum_kernel", "analysis_least_s"),
    ("bank_roofline.serve", "harmonic_bank_kernel", "bank_least_s"),
    ("bank_bwd_roofline.train", "harmonic_bank_bwd_kernel",
     "bank_bwd_least_s")])
@pytest.mark.parametrize("split", [1, 3])
def test_roofline_share_is_at_most_100(name, kernel, key, split):
    least = 2.5e-5
    share = _reader(name)(_records(kernel, least, key, split=split))
    assert share == pytest.approx(100.0)
    slower = _reader(name)(_records(kernel, least, key, split=split,
                                    slower=1.7))
    assert slower == pytest.approx(100.0 / 1.7)


def test_a_reader_that_finds_nothing_returns_nothing():
    rec = _records("some_other_kernel", 1e-5, "bank_least_s")
    assert _reader("bank_roofline.serve")(rec) is None
    assert _reader("bank_roofline.serve")(None) is None
    assert _reader("mfu.serve")(tracing.Records([], [], 1, {}, {})) is None


def test_bank_forward_does_not_match_the_backward():
    rec = _records("harmonic_bank_bwd_kernel", 1e-5, "bank_least_s")
    assert _reader("bank_roofline.serve")(rec) is None


def test_analysis_least_time_is_bound_by_bytes_at_serving_widths():
    cfg = Config()
    n, K, R = 1022, 512, 10240
    assert formulas.analysis_least_s(cfg, R) == pytest.approx(
        4 * (R * n + n + 2 * R * K) / formulas.PEAK_HBM_BYTES)
