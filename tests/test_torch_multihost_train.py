"""Sharded training with the port (``make_sharded_train_step`` /
``make_sharded_gan_step`` over ``torch.distributed``; the counterpart of
tests/test_multihost_spawn.py), against one process and against the JAX
package's sharded step.

Two gloo ranks on the CPU, each with its half of a 4-utterance batch
(model_parallel 1), or both with all of it and the weights split over them
(model_parallel 2), take 3 steps of the joint and of the GAN objective.
One rank on the whole batch is the reference.  The losses are the global
batch's on every rank, so they agree with one process to 1e-5 relative
along each run's own 3 steps.  The gradients are held at the states the
reference started each step from (each worker loads them), to 1e-4 of
each subtree's peak: along their own steps the runs part by float32
rounding that AdamW's normalised first steps amplify, and the wave
decoder's gradient follows the rounding of the render's quietest STFT
bins (ROADMAP.md §3).  Tiny model config, float32, seeded perturbed
weights, batch from the port's ``make_batch``."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_multihost as tm
from realtime_yukarin_tpu.models import voice_changer as j_vc
from realtime_yukarin_tpu.parallel.mesh import make_mesh as j_make_mesh
from realtime_yukarin_tpu.training import train_step as j_ts
from realtime_yukarin_tpu_torch.models import voice_changer as t_vc
from realtime_yukarin_tpu_torch.training.data import make_batch
from torch_parity import ALL_NETS, perturbed_params, training_configs

STEPS = 3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SUBTREES = ("stage1", "stage2", "vocoder", "vocoder_wave", "disc/")
TINY_YAML = """\
acoustic: {hidden: 32, num_blocks: 2}
super_resolution: {hidden: 64, num_blocks: 2}
vocoder_nn: {hidden: 32, num_blocks: 2}
vocoder_wave: {hidden: 32, num_blocks: 2, phase_harmonics: 4,
               phase_fractional: 2}
compute_dtype: float32
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost_train")
    jc, tc = training_configs()
    jp, _, flat = perturbed_params(jc, tc, prefixes=ALL_NETS)
    np.savez(d / "params.npz", **flat)
    (d / "config.json").write_text(json.dumps(tc.to_dict()))
    batch = make_batch(tc, 4, seconds=0.1, seed=0, device="cpu")
    np.savez(d / "batch.npz", **{f.name: getattr(batch, f.name).numpy()
                                 for f in dataclasses.fields(batch)})
    tm.run_ranks(d, "train", 1, steps=STEPS, tag="one")
    tm.wait_ranks(
        tm.start_ranks(d, "train", 2, steps=STEPS, ref="one", tag="dp"),
        tm.start_ranks(d, "train", 2, steps=STEPS, ref="one",
                       model_parallel=2, tag="mp"))
    return {"dir": d, "jc": jc, "jp": jp, "flat": flat}


def _grad_errors(got: dict, ref: dict, prefix: str) -> dict[str, float]:
    """{subtree: max |got - ref| / max |ref|} over the gradients under
    ``prefix`` (f0_stats: 0 on both, the loss does not read them)."""
    out = {}
    for sub in SUBTREES:
        names = [n for n in ref if n.startswith(prefix + sub)]
        if not names:
            continue
        peak = max(np.abs(ref[n]).max() for n in names)
        assert peak > 0, sub
        out[sub] = max(np.abs(got[n] - ref[n]).max() for n in names) / peak
    for n in ref:
        if n.startswith(prefix + "f0_stats/"):
            assert got[n] == 0 == ref[n], n
    return out


@pytest.mark.parametrize("objective", ["joint", "gan"])
@pytest.mark.parametrize("tag", ["dp", "mp"])
def test_two_ranks_match_one_process(runs, tag, objective):
    ref = tm.load(runs["dir"], "train", "one", 0)
    ranks = [tm.load(runs["dir"], "train", tag, r) for r in range(2)]
    losses = [n for n in ref if n.startswith(objective)
              and "/loss/" in n]
    assert len(losses) == STEPS * (7 if objective == "gan" else 5)
    for n in losses:
        # the global batch's value, the same on every rank
        assert float(ranks[0][n]) == float(ranks[1][n]), n
        assert float(ranks[0][n]) == pytest.approx(float(ref[n]),
                                                    rel=LOSS_TOL), n
    for k in range(STEPS):
        errs = _grad_errors(ranks[0], ref, f"{objective}/{k}/grad/")
        assert max(errs.values()) < GRAD_TOL, (k, errs)
        for n in ref:
            if n.startswith(f"{objective}/{k}/grad/"):
                np.testing.assert_array_equal(ranks[0][n], ranks[1][n],
                                              err_msg=n)
    # every subtree trained
    final = [n for n in ref if n.startswith(f"{objective}/param/")]
    moved = {n.split("/")[2] for n in final
             if not np.array_equal(ranks[0][n], runs["flat"][
                 n[len(objective) + 7:]])}
    assert {"stage1", "stage2", "vocoder", "vocoder_wave"} <= moved


def test_sharded_step_matches_jax(runs):
    """The JAX package's make_sharded_train_step on the 8-device mesh
    (data 4 x model 2), on the same global batch and weights, against the
    two ranks at model_parallel 2: the first step's losses to 1e-4
    relative and gradients to 2e-3 of each subtree's peak
    (tests/test_torch_training.py's tolerances).  An optimizer that passes
    the gradients through makes the step's update its gradient."""
    jc, jp, flat = runs["jc"], runs["jp"], runs["flat"]
    passthrough = optax.GradientTransformation(
        lambda p: optax.EmptyState(), lambda u, s, p=None: (u, s))
    step, shard_state, shard_batch = j_ts.make_sharded_train_step(
        jc, j_make_mesh(model_parallel=2), passthrough)
    with np.load(runs["dir"] / "batch.npz") as f:
        batch = j_ts.Batch(**{k: jnp.asarray(f[k]) for k in f.files})
    state = shard_state(j_ts.init_train_state(jp, passthrough))
    state, metrics = step(state, shard_batch(batch))
    after = j_vc.flatten_params(state.params)
    grads = {n: after[n] - flat[n] for n in flat}
    got = tm.load(runs["dir"], "train", "mp", 0)
    for k, v in metrics.items():
        assert float(got[f"joint/0/loss/{k}"]) == pytest.approx(
            float(v), rel=1e-4), k
    ref = {f"joint/0/grad/{n}": v for n, v in grads.items()}
    errs = _grad_errors(got, ref, "joint/0/grad/")
    assert set(errs) == {"stage1", "stage2", "vocoder", "vocoder_wave"}
    assert max(errs.values()) < 2e-3, errs


def test_cli_two_ranks_checkpoint_export_resume(tmp_path):
    """``cli.train --synthetic --gan --model_parallel 2`` at two ranks
    writes whole checkpoints and an export the JAX package's load_params
    takes; resumed from its step-2 checkpoint it takes the same third step
    (the same loss line, the same exported weights, bit for bit) as the
    run that did not stop."""
    jc, tc = training_configs()
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    common = ["--synthetic", "--gan", "--model_parallel", "2",
              "--batch_size", "2", "--crop_frames", "20", "--device", "cpu",
              "--log_every", "1", "--config_path", str(cfg), "--steps", "3"]
    cli = "realtime_yukarin_tpu_torch.cli.train"
    a = tm.run_cli(cli, common + ["--ckpt_dir", str(tmp_path / "ck"),
                                  "--ckpt_every", "2", "--export_params",
                                  str(tmp_path / "a.npz")], 2)
    assert "step 3/3" in a[0] and "[train]" not in a[1]
    assert sorted(p.name for p in (tmp_path / "ck").glob("ckpt_*.pt")) == [
        "ckpt_2.pt", "ckpt_3.pt"]
    resume = tmp_path / "resume"
    shutil.copytree(tmp_path / "ck", resume)
    (resume / "ckpt_3.pt").unlink()
    (resume / "latest").write_text("ckpt_2.pt")
    b = tm.run_cli(cli, common + ["--ckpt_dir", str(resume),
                                  "--export_params",
                                  str(tmp_path / "b.npz")], 2)
    assert "resumed from step 2" in b[0]

    def step3(log):
        line = next(x for x in log.splitlines() if "step 3/3" in x)
        return line.split("(")[0]
    assert step3(a[0]) == step3(b[0])
    with np.load(tmp_path / "a.npz") as fa, np.load(tmp_path / "b.npz") as fb:
        assert set(fa.files) == set(fb.files)
        for n in fa.files:
            np.testing.assert_array_equal(fa[n], fb[n], err_msg=n)
    loaded = j_vc.load_params(j_vc.init_params(jax.random.key(0), jc),
                              str(tmp_path / "a.npz"))
    flat = j_vc.flatten_params(loaded)
    port = t_vc.load_params_npz(str(tmp_path / "a.npz"), tc)
    for n, v in t_vc.params_to_jax(port).items():
        np.testing.assert_array_equal(v, flat[n])
    assert np.abs(flat["stage1/params/head/kernel"]).max() > 0
