"""Multi-process serving with the port (``BatchedServer.step_local`` over
``torch.distributed``; the counterpart of tests/test_multihost_serving.py).

Two gloo ranks on the CPU run one 8-lane server: each feeds only its
``local_slots`` rows through ``step_local``, under the JAX test's schedule
(a pause on slot 1 at tick 2, a reset of slot 6 at tick 3).  Stitched
together, their rows are bit-equal to the same worker at one rank with all
8 lanes: at model_parallel 1 a lane's computation does not depend on the
lanes beside it.  With the model split (two ranks, one model group) each
rank serves all 8 lanes and gathers every split layer's channels; it
agrees with one rank to 1e-6 of the peak, since the CPU's convolution and
matrix product sum a half-width weight in another order (not bit for
bit).  Each rank also counts one step (``step_cost_analysis``) and its
learned stages (``model_stage_flops``): over the data split the ranks'
counts sum to one rank's; over the model split each rank counts its shard
of every split layer and the replicated ones in full.  Tiny model config,
float32, seeded perturbed weights."""

import json

import numpy as np
import pytest

import torch_multihost as tm
from torch_parity import configs, perturbed_params

N, TICKS = 8, 5
MP_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost_serving")
    jc, tc = configs()
    np.savez(d / "params.npz", **perturbed_params(jc, tc)[2])
    (d / "config.json").write_text(json.dumps(tc.to_dict()))
    tm.wait_ranks(
        tm.start_ranks(d, "serve", 1, n=N, ticks=TICKS, tag="one"),
        tm.start_ranks(d, "serve", 2, n=N, ticks=TICKS, tag="dp"),
        tm.start_ranks(d, "serve", 2, n=N, ticks=TICKS, model_parallel=2,
                       tag="mp"))
    return d


def test_two_ranks_equal_one_process(runs):
    ref = tm.load(runs, "serve", "one", 0)["out"]           # [T, n, So]
    got = np.full_like(ref, np.nan)
    for rank in range(2):
        o = tm.load(runs, "serve", "dp", rank)
        lo, hi = o["range"]
        assert (lo, hi) == (rank * N // 2, (rank + 1) * N // 2)
        assert int(o["num_streams"]) == N
        got[:, lo:hi] = o["out"]
    assert np.isfinite(got).all(), "uncovered slots"
    np.testing.assert_array_equal(got, ref)
    # the pause and the reset did something
    assert np.all(ref[2, 1] == 0.0) and np.abs(ref[2, 0]).max() > 0
    assert not np.array_equal(ref[3, N - 2], ref[3, N - 3])


def test_model_split_matches_one_rank(runs):
    ref = tm.load(runs, "serve", "one", 0)["out"]
    outs = [tm.load(runs, "serve", "mp", r) for r in range(2)]
    for o in outs:
        # every rank of the model group serves the same (all) slots
        assert tuple(o["range"]) == (0, N)
        err = np.abs(o["out"] - ref).max() / np.abs(ref).max()
        assert err < MP_TOL, err
        assert np.all(o["out"][2, 1] == 0.0)
    np.testing.assert_array_equal(outs[0]["out"], outs[1]["out"])


def test_data_split_counts_sum_to_one_rank(runs):
    one = tm.load(runs, "serve", "one", 0)
    ranks = [tm.load(runs, "serve", "dp", r) for r in range(2)]
    for key in ("flops", "model_flops"):
        assert float(one[key]) > 0
        assert sum(float(o[key]) for o in ranks) == float(one[key]), key
    assert all(float(o["bytes"]) > 0 for o in ranks)


def test_model_split_counts_each_rank_its_shard(runs):
    one = float(tm.load(runs, "serve", "one", 0)["model_flops"])
    ranks = [float(tm.load(runs, "serve", "mp", r)["model_flops"])
             for r in range(2)]
    assert all(0 < m < one for m in ranks), (ranks, one)
    assert sum(ranks) >= one, (ranks, one)
