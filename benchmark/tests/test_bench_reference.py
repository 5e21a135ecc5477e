"""The frozen reference agrees with the program's plain CPU path at a tiny
configuration: the streaming step over several chunks of two lanes, a
pair's preparation and the sampler's draws, and the joint step's loss."""

import numpy as np
import pytest
import torch

from benchmark import cellkit, corpus, signals
from benchmark.reference import lanes as ref_lanes
from benchmark.reference import training as ref_training
from benchmark.reference.config import Config as RefConfig
from benchmark.weights import make_weights
from realtime_yukarin_tpu_torch.config import Config

TINY = {"acoustic": {"hidden": 32, "num_blocks": 2},
        "super_resolution": {"hidden": 64, "num_blocks": 2},
        "vocoder_nn": {"hidden": 32, "num_blocks": 2},
        "vocoder_wave": {"hidden": 32, "num_blocks": 2},
        "compute_dtype": "float32"}
SPEC = {"head_scale": 0.1, "bias_scale": 0.01,
        "f0_stats": {"src_mean": 160.0, "src_std": 0.25, "tgt_mean": 220.0,
                     "tgt_std": 0.25}}
CPU = torch.device("cpu")


def _both(extra=None):
    d = {**TINY, **(extra or {})}
    cfg, ref_cfg = Config.from_dict(d), RefConfig.from_dict(d)
    w = make_weights(ref_cfg, SPEC, 3, CPU)
    return cfg, ref_cfg, w


@pytest.mark.parametrize("extra", [None, {"streaming": {"chunk_ms": 20.0},
                                          "dsp": {"input_rate": 48000,
                                                  "output_rate": 48000}}])
def test_streaming_step_matches_the_program(extra):
    from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
    cfg, ref_cfg, w = _both(extra)
    server = BatchedServer(cellkit.program_params(w, cfg), cfg,
                           num_streams=2, seed=5, device=CPU)
    S = server.chunk_samples
    x = signals.speech_pool(2, 8 * S / ref_cfg.dsp.in_rate,
                            ref_cfg.dsp.in_rate, 4, CPU)
    live = np.ones((8, 2), bool)
    live[3, 1] = False
    prog = np.stack([server.step(x[:, t * S: (t + 1) * S], live[t])
                     for t in range(8)])
    from benchmark.reference.streaming.pipeline import lane_noise_keys
    keys = torch.tensor(lane_noise_keys(5, 2), dtype=torch.int64)
    chunks = x[:, : 8 * S].reshape(2, 8, S).transpose(1, 0, 2)
    ref = ref_lanes.replay(cellkit.reference_params(w, ref_cfg, CPU),
                           ref_cfg, keys, chunks, live, CPU)
    assert np.abs(prog).max() > 1e-3
    np.testing.assert_allclose(prog, ref, rtol=0, atol=1e-5)


def test_preparation_sampling_and_loss_match_the_program(tmp_path):
    from realtime_yukarin_tpu_torch.training.corpus import prepare_corpus
    from realtime_yukarin_tpu_torch.training.dataset import CorpusDataset
    from realtime_yukarin_tpu_torch.training.train_step import (
        init_train_state, loss_fn)
    cfg, ref_cfg, w = _both()
    spec = {"pairs": 3, "seconds": [0.6, 0.9], "target_ratio": 1.1}
    pairs = corpus.formant_pairs(tmp_path, spec, 24000, [9, 5])
    prepare_corpus(str(tmp_path / "src"), str(tmp_path / "tgt"),
                   str(tmp_path / "prep"), cfg, bucket_frames=32,
                   verbose=False, device=CPU)
    ds = CorpusDataset(str(tmp_path / "prep"), cfg, crop_frames=20, seed=77,
                       device=CPU)
    sampler = ref_training.Sampler(pairs, ref_cfg, 20, 77, 32, CPU)
    for _ in range(2):
        b, r = ds.sample_batch(2), sampler.batch(2)
        for k, v in r.items():
            np.testing.assert_allclose(getattr(b, k).numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    state = init_train_state(cellkit.program_params(w, cfg), CPU)
    with torch.no_grad():
        lp, _ = loss_fn(state.params, b, cfg)
        lr = ref_training.joint_loss(
            cellkit.reference_params(w, ref_cfg, CPU), r, ref_cfg)
    assert float(lp) == pytest.approx(float(lr), rel=1e-5)
