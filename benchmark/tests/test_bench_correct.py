"""``correct`` holds for a sound run and fails for a broken one.

Each run here is the harness's own (the look for a card skipped) at a tiny
size on the CPU, with the program in float32 so that a sound run meets the
reference; the timed path is broken underneath for each fault a cell can
have, and the cell's real limits (``checks/<cell>.json``) must catch it:
a step that leaves its state unchanged, half of the batch left out, an
answer altered where it is produced, and, for the lane masks, a join that
does not reset its lane and a paused lane whose state advances.  (No cell
spans chips, so there is no exchange between them to leave out.)  The control, the reference one
precision lower in the program's place, must fail the limits too; TF32
exists on the card only, so the training cell's control is read there.
"""

import pytest
import torch

from benchmark import harness
from benchmark.readings import readings

SERVE = ("default.serve512", "lowlat20.serve512")
TRAIN = ("default.train",)


def _serve_unchanged(mp):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer

    def step(self):
        out, _ = self._step(self._params, self._init_carry, self._carries,
                            self._chunks, self._keys, self._live,
                            self._reset)
        return out
    mp.setattr(BatchedServer, "_program_step", step)


def _serve_half(mp):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    from realtime_yukarin_tpu_torch.streaming.state import tree_copy_

    def step(self):
        n = len(self._live)
        keep = self._live & (torch.arange(n) < n // 2)
        out, carries = self._step(self._params, self._init_carry,
                                  self._carries, self._chunks, self._keys,
                                  keep, self._reset)
        tree_copy_(self._carries, carries)
        return out
    mp.setattr(BatchedServer, "_program_step", step)


def _serve_altered(mp):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    real = BatchedServer.step
    ticks = [0]

    def step(self, *args, **kw):
        out = real(self, *args, **kw)
        ticks[0] += 1
        return out * 0.5 if ticks[0] % 2 == 0 else out
    mp.setattr(BatchedServer, "step", step)


def _serve_no_reset(mp):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    from realtime_yukarin_tpu_torch.streaming.state import tree_copy_

    def step(self):
        out, carries = self._step(self._params, self._init_carry,
                                  self._carries, self._chunks, self._keys,
                                  self._live, torch.zeros_like(self._reset))
        tree_copy_(self._carries, carries)
        return out
    mp.setattr(BatchedServer, "_program_step", step)


def _serve_paused_advance(mp):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    from realtime_yukarin_tpu_torch.streaming.state import tree_copy_

    def step(self):
        out, carries = self._step(self._params, self._init_carry,
                                  self._carries, self._chunks, self._keys,
                                  torch.ones_like(self._live), self._reset)
        tree_copy_(self._carries, carries)
        return torch.where(self._live[:, None], out, torch.zeros_like(out))
    mp.setattr(BatchedServer, "_program_step", step)


def _train_unchanged(mp):
    from realtime_yukarin_tpu_torch.training import train_step

    def apply_gradients(opt, params, grads, mesh=None):
        opt.zero_grad(set_to_none=True)
    mp.setattr(train_step, "apply_gradients", apply_gradients)


def _train_half(mp):
    import dataclasses

    from realtime_yukarin_tpu_torch.training import train_step
    real = train_step._losses

    def losses(params, batch, cfg, mesh=None):
        half = batch.f0_src.shape[0] // 2
        sub = train_step.Batch(**{f.name: getattr(batch, f.name)[:half]
                                  for f in dataclasses.fields(batch)})
        return real(params, sub, cfg, mesh)
    mp.setattr(train_step, "_losses", losses)


FAULTS = (
    [(c, "unchanged", _serve_unchanged) for c in SERVE]
    + [(c, "half_batch", _serve_half) for c in SERVE]
    + [(c, "altered", _serve_altered) for c in SERVE]
    + [(c, "no_reset", _serve_no_reset) for c in SERVE]
    + [(c, "paused_advance", _serve_paused_advance) for c in SERVE]
    + [(c, "unchanged", _train_unchanged) for c in TRAIN]
    + [(c, "half_batch", _train_half) for c in TRAIN])

# a lane-mask fault touches few of a full-size cell's chunks, so the number
# for the chunks that mask decides has to catch it by itself
MASK_NUMBER = {"no_reset": "mask_err_mean", "paused_advance": "mask_err_mean"}


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(tiny_root, run_tiny, cell):
    res = run_tiny(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_fault_is_not_correct(tiny_root, run_tiny, monkeypatch, cell,
                                fault, plant):
    plant(monkeypatch)
    res = run_tiny(tiny_root, cell)
    assert not res["correct"], res["checks"]
    if fault in MASK_NUMBER:        # the number for the chunks a mask decides
        c = res["checks"][MASK_NUMBER[fault]]
        assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_the_control_is_not_correct(tiny_root, cell):
    """Over a window of some seconds of audio: the control's error grows
    with a lane's history, and a tiny run's ticks are few."""
    limits = harness.load_cell(cell, tiny_root).limits
    for r in readings(cell, [5, 2 ** 31 + 9], 10.0, torch.device("cpu"),
                      tiny_root):
        n = r["numbers"]
        assert all(n[k] <= spec["limit"] for k, spec in limits.items()), n
        assert any(n[f"control_{k}"] > spec["limit"]
                   for k, spec in limits.items()), n


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN)
def test_the_training_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32, the training control's precision, needs a GPU")
    limits = harness.load_cell(cell).limits
    for r in readings(cell, [5, 6, 7], 2.0):
        n = r["numbers"]
        assert any(n[f"control_{k}"] > spec["limit"]
                   for k, spec in limits.items()), n
