"""Every generator of inputs gives the same inputs for the same seed, and
other inputs for another seed."""

import hashlib
import json

import numpy as np
import torch

from benchmark import corpus, harness, signals, weights
from benchmark.churn import Churn
from benchmark.reference.config import Config

SERVE = json.loads((harness.BENCH / "traffic" / "serve512.json").read_text())
BIG = 2 ** 31 + 12345


def _ticks(seed, n=400):
    c = Churn(SERVE, 0.1, 2400, 48000, 8, [seed, 3])
    return [np.concatenate([a.astype(np.int64) for a in c.tick()])
            for _ in range(n)]


def test_churn_is_deterministic_per_seed():
    a, b, c = _ticks(BIG), _ticks(BIG), _ticks(BIG + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_churn_work_does_not_depend_on_the_seed():
    """Every tick after the first converts the same number of lanes on
    every seed, and about as many lanes join on each."""
    N, call = SERVE["lanes"], round(SERVE["call_s"] / 0.1)
    paused = round(SERVE["pause_share"] * N)
    for seed in (1, BIG, 2 ** 32 + 5):
        c = Churn(SERVE, 0.1, 2400, 48000, 8, [seed, 3])
        ticks = [c.tick() for _ in range(3 * call)]
        assert ticks[0][0].all()
        assert all(live.sum() == N - paused for live, *_ in ticks[1:])
        joins = [reset.sum() for _, reset, *_ in ticks[1:]]
        assert N // call <= min(joins) <= max(joins) <= -(-N // call)


def test_churn_resets_each_join_and_pauses_its_share():
    c = Churn(SERVE, 0.1, 2400, 48000, 8, [BIG, 3])
    call = round(SERVE["call_s"] / 0.1)
    ticks = [c.tick() for _ in range(2 * call + 1)]
    assert ticks[0][1].all()                   # every caller starts fresh
    reset = np.stack([r for _, r, _, _ in ticks])
    live = np.stack([v for v, _, _, _ in ticks])
    assert (reset[1:].sum(0) == 2).all()       # one join per call_s a lane
    assert not (reset & ~live).any()           # a join is never paused
    _, _, sig, pos = ticks[5]
    _, _, sig6, pos6 = ticks[6]
    held = ~live[5] & ~reset[6]                # a pause resumes in place
    assert (pos6[held] == pos[held]).all() and (sig6[held] == sig[held]).all()


def test_speech_pool_is_deterministic_per_seed():
    cpu = torch.device("cpu")
    a = signals.speech_pool(3, 0.5, 24000, BIG, cpu)
    b = signals.speech_pool(3, 0.5, 24000, BIG, cpu)
    c = signals.speech_pool(3, 0.5, 24000, BIG + 1, cpu)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (3, 12000) and 0.1 < np.abs(a).max() <= 0.85


def _digest(paths):
    h = hashlib.sha256()
    for s, t in paths:
        h.update(s.read_bytes())
        h.update(t.read_bytes())
    return h.hexdigest()


def test_corpus_is_deterministic_per_seed(tmp_path):
    spec = {"pairs": 3, "seconds": [0.5, 0.8], "target_ratio": 1.1}
    a = corpus.formant_pairs(tmp_path / "a", spec, 24000, [BIG, 5])
    b = corpus.formant_pairs(tmp_path / "b", spec, 24000, [BIG, 5])
    c = corpus.formant_pairs(tmp_path / "c", spec, 24000, [BIG + 1, 5])
    assert _digest(a) == _digest(b) != _digest(c)


def test_weights_are_deterministic_per_seed():
    spec = json.loads((harness.BENCH / "configs" / "default.json")
                      .read_text())["weights"]
    cfg = Config.from_dict({"acoustic": {"hidden": 16, "num_blocks": 1}})
    cpu = torch.device("cpu")
    a = weights.make_weights(cfg, spec, 11, cpu)
    b = weights.make_weights(cfg, spec, 11, cpu)
    c = weights.make_weights(cfg, spec, 12, cpu)
    same = all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])
    assert same
    assert not torch.equal(a["stage1"]["head.weight"],
                           c["stage1"]["head.weight"])
    assert a["stage1"]["head.weight"].abs().max() > 0     # heads active
