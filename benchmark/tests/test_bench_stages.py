"""``stages.py`` and the per-layer readers built on it, on synthetic records
with marker kernels, device operations and host spans at known times: each
reader's milliseconds per step, None where the trace holds no marker or not
the span, and the markers charged to no stage."""

import pytest

from benchmark import harness, stages
from benchmark.tracing import Records

TICK = 1000.0                     # us between two traced ticks


def _tick(t0: float, markers: bool = True, spans: bool = True):
    """One traced serving tick from ``t0`` (us): (device ops, host spans).
    Per tick: carry 3 + 2, resample 1 + 1, analysis 15, stage 1 9, SR 0
    (marked, nothing run), render 20 us; every marker 5 us long; the copies
    in and out and the output's clone outside every stage.  Device idle
    inside copy_in 6 us, inside the program's call 12 us, inside copy_out
    4 us."""
    dev = [("Memcpy HtoD (Pageable -> Device)", t0 + 10, t0 + 14)]
    plan = [("carry_in", [3.0]), ("resample_in", [1.0]),
            ("analysis", [10.0, 5.0]), ("stage1", [9.0]), ("sr", []),
            ("render", [20.0]), ("resample_out", [1.0]),
            ("carry_out", [2.0])]
    t = t0 + 30
    for stage, ops in plan:
        if markers:
            dev.append((f"stage_begin_{stage}", t, t + 5))
            t += 5
        for i, d in enumerate(ops):
            dev.append((f"void at::native::kernel_{stage}_{i}<float>()", t,
                        t + d))
            t += d
    if markers:
        dev.append(("stage_end", t, t + 5))
        t += 5
    dev.append(("void at::native::copy_kernel<float>()", t, t + 2))  # clone
    dev.append(("Memcpy DtoH (Device -> Pageable)", t0 + 300, t0 + 340))
    host = [("host.step", t0, t0 + 400),
            ("host.server_step", t0 + 5, t0 + 350)]
    if spans:
        host += [("host.serve.copy_in", t0 + 8, t0 + 18),
                 ("host.program.call", t0 + 18, t0 + 30),
                 ("host.serve.copy_out", t0 + 298, t0 + 342)]
    return dev, host


def _records(steps: int = 2, **kw) -> Records:
    device, host = [], []
    for k in range(steps):
        d, h = _tick(k * TICK, **kw)
        device += d
        host += h
    return Records(device=device, host=host, steps=steps, counters={},
                   info={})


SERVE = {"analysis_ms.serve": 0.015, "stage1_ms.serve": 0.009,
         "sr_ms.serve": 0.0, "render_ms.serve": 0.020,
         "carry_ms.serve": 0.005, "resample_ms.serve": 0.002,
         "copy_in_idle_ms.serve": 0.006, "copy_out_idle_ms.serve": 0.004}


@pytest.mark.parametrize("metric", sorted(SERVE))
def test_each_serving_reader_gives_its_ms_per_tick(metric):
    v = harness.reader(metric)(_records(steps=3))
    assert v == pytest.approx(SERVE[metric], abs=1e-12)


def _train_records() -> Records:
    """Two training steps: forward 30, backward 50, optimizer 8 us, the
    batch's copy and the draws outside; 7 us idle inside each draw."""
    device, host = [], []
    for k in range(2):
        t0 = k * TICK
        host += [("host.step", t0, t0 + 500),
                 ("host.data.draw", t0, t0 + 20),
                 ("host.data.copy_in", t0 + 20, t0 + 30)]
        device += [("Memcpy HtoD (Pageable -> Device)", t0 + 7, t0 + 20),
                   ("Memcpy DtoD (Device -> Device)", t0 + 40, t0 + 42),
                   ("stage_begin_forward", t0 + 50, t0 + 51),
                   ("conv_fwd", t0 + 51, t0 + 71),
                   ("stft", t0 + 71, t0 + 81),
                   ("stage_begin_backward", t0 + 81, t0 + 82),
                   ("harmonic_bank_bwd_kernel<4>(float const*)", t0 + 82,
                    t0 + 132),
                   ("stage_begin_optimizer", t0 + 132, t0 + 133),
                   ("multi_tensor_apply_kernel", t0 + 133, t0 + 141),
                   ("stage_end", t0 + 141, t0 + 142)]
    return Records(device=device, host=host, steps=2, counters={}, info={})


@pytest.mark.parametrize("metric,ms", [
    ("forward_ms.train", 0.030), ("backward_ms.train", 0.050),
    ("optimizer_ms.train", 0.008), ("draw_idle_ms.train", 0.007)])
def test_each_training_reader_gives_its_ms_per_step(metric, ms):
    assert harness.reader(metric)(_train_records()) == pytest.approx(
        ms, abs=1e-12)


def test_markers_are_charged_to_no_stage():
    rec = _records()
    per = stages.split(rec.device)
    stage_ops = sum(e - s for n, s, e in rec.device
                    if "at::native::kernel_" in n)
    assert sum(per.values()) == pytest.approx(stage_ops)
    # the markers' own 45 us a tick, the copies and the clone are outside
    busy = sum(e - s for _, s, e in rec.device)
    assert busy - sum(per.values()) == pytest.approx(2 * (45 + 4 + 40 + 2))
    assert set(per) == {"carry_in", "resample_in", "analysis", "stage1",
                        "sr", "render", "resample_out", "carry_out"}


def test_the_order_of_the_records_does_not_matter():
    rec = _records()
    assert stages.split(rec.device[::-1]) == stages.split(rec.device)


def test_a_demangled_marker_name_is_read_alike():
    ops = [("void stage_begin_render()", 0, 1), ("k", 1, 4),
           ("void stage_end()", 4, 5), ("k", 5, 9)]
    assert stages.split(ops) == {"render": 3}


def test_without_markers_or_spans_the_readers_give_nothing():
    bare = _records(markers=False, spans=False)
    for metric in SERVE:
        assert harness.reader(metric)(bare) is None
        assert harness.reader(metric)(None) is None
    assert stages.split(bare.device) == {}
    # a kernel whose name only contains a marker's is no marker
    assert stages.split([("gemm_stage_end_tile", 0, 1),
                         ("cutlass_stage_begin_x_sm90", 1, 2)]) == {}


def test_a_span_without_device_records_reads_nothing():
    rec = _records()
    rec.device = []
    assert stages.idle_ms_in(rec, "host.serve.copy_in") is None
    assert stages.stage_ms(rec, ("analysis",)) is None


def test_idle_is_clipped_to_the_window():
    """A span reaching past the traced window's end counts only inside."""
    rec = _records(steps=1)
    lo, hi = rec.window()
    rec.host.append(("host.tail", hi - 10, hi + 500))
    assert stages.idle_ms_in(rec, "host.tail") == pytest.approx(0.010)
