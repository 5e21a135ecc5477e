"""The port's corpus path against the JAX package's on the CPU: F0
statistics, DTW alignment, the formant corpus, ``prepare_corpus``,
``CorpusDataset`` and the evaluation metrics.

A 2-pair 0.6 s formant corpus (plus the held-out pair) is built and
prepared by each package at ``bucket_frames=32`` with the tiny config,
in float32; the module builds its own corpora (conftest's
``trained_formant`` would train 600 JAX steps on this worker), the port's
shared with tests/test_torch_full_chain.py when both run in one process.
The JAX package's eager analysis runs under ``jax.jit``
(``torch_parity.jax_references_jitted``).  A CPU tensor never launches a
kernel."""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_yukarin_tpu.cli import evaluate as j_eval_cli
from realtime_yukarin_tpu.models import f0_stats as j_f0s
from realtime_yukarin_tpu.training import align as j_align
from realtime_yukarin_tpu.training import corpus as j_corpus
from realtime_yukarin_tpu.training import data as j_data
from realtime_yukarin_tpu.training import dataset as j_dataset
from realtime_yukarin_tpu.training import evaluate as j_evaluate
from realtime_yukarin_tpu.dsp.world import AcousticFeature as JFeature
from realtime_yukarin_tpu_torch.cli import evaluate as t_eval_cli
from realtime_yukarin_tpu_torch.cli import prepare as t_prepare_cli
from realtime_yukarin_tpu_torch.dsp.world import AcousticFeature as TFeature
from realtime_yukarin_tpu_torch.models import f0_stats as t_f0s
from realtime_yukarin_tpu_torch.models import voice_changer as t_vc
from realtime_yukarin_tpu_torch.ops import cuda
from realtime_yukarin_tpu_torch.training import align as t_align
from realtime_yukarin_tpu_torch.training import corpus as t_corpus
from realtime_yukarin_tpu_torch.training import data as t_data
from realtime_yukarin_tpu_torch.training import dataset as t_dataset
from realtime_yukarin_tpu_torch.training import evaluate as t_evaluate
from realtime_yukarin_tpu_torch.training import full_chain as t_fc

from torch_parity import configs, jax_jitted, port_formant_corpus, t32

FEATURES = ("f0", "mc", "ap", "env")


@pytest.fixture(autouse=True)
def _zero_counts():
    cuda.reset_counts()
    yield
    assert all(k.launches == 0 for k in cuda.KERNELS)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, jax_jitted):
    jc, tc = configs()
    jdirs = j_data.build_formant_corpus(
        tmp_path_factory.mktemp("torch_corpus_jax"), jc, n_train=2)
    tdirs = port_formant_corpus(tmp_path_factory, tc)
    return jc, tc, jdirs, tdirs


def _load(path) -> dict:
    with np.load(path) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# F0 statistics
# ---------------------------------------------------------------------------

def test_f0_statistics_and_convert_f0_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    f0 = rng.uniform(90.0, 260.0, 400).astype(np.float32)
    f0[rng.random(400) < 0.3] = 0.0
    js = j_f0s.F0Statistics.from_f0(f0)
    ts = t_f0s.F0Statistics.from_f0(f0)
    assert (ts.mean, ts.std) == (js.mean, js.std)
    tgt = t_f0s.F0Statistics(mean=float(np.log(210.0)), std=0.2)
    # the same .npz layout, read across packages
    ts.save(tmp_path / "t.npz")
    js.save(tmp_path / "j.npz")
    assert j_f0s.F0Statistics.load(tmp_path / "t.npz") == js
    assert t_f0s.F0Statistics.load(tmp_path / "j.npz") == ts
    out_t = t_f0s.convert_f0(t32(f0), ts, tgt).numpy()
    out_j = np.asarray(j_f0s.convert_f0(
        jnp.asarray(f0), js, j_f0s.F0Statistics(tgt.mean, tgt.std)))
    np.testing.assert_array_equal(out_t > 0, f0 > 0)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="no voiced frames"):
        t_f0s.F0Statistics.from_f0(np.zeros(5, np.float32))


def test_load_all_params_reads_f0_statistics(tmp_path):
    jc, tc = configs()
    t_f0s.F0Statistics(mean=5.0, std=0.3).save(tmp_path / "in.npz")
    t_f0s.F0Statistics(mean=5.4, std=0.2).save(tmp_path / "tgt.npz")
    cfg = type(tc).from_dict(dict(
        tc.to_dict(), input_statistics_path=str(tmp_path / "in.npz"),
        target_statistics_path=str(tmp_path / "tgt.npz")))
    params = t_vc.init_params(cfg, torch.Generator().manual_seed(0))
    got = t_vc.load_all_params(params, cfg)["f0_stats"]
    want = t_f0s.f0_stats_params(t_f0s.F0Statistics(5.0, 0.3),
                                 t_f0s.F0Statistics(5.4, 0.2))
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert float(got[k]) == float(v), k


# ---------------------------------------------------------------------------
# DTW alignment
# ---------------------------------------------------------------------------

def _dtw_case(name: str, corpora):
    if name == "identity":
        x = np.random.default_rng(0).standard_normal((40, 8))
        return x.astype(np.float32), x.astype(np.float32)
    if name == "known_warp":
        x = np.random.default_rng(1).standard_normal((30, 8))
        reps = np.ones(30, np.int64)
        reps[::3] = 2
        return x.astype(np.float32), np.repeat(x, reps, 0).astype(np.float32)
    _, _, jdirs, _ = corpora
    d = _load(jdirs["prep_tr"] / "utt0.npz")
    return d["mc_src"][:, 1:], d["mc_voc"][:, 1:]


@pytest.mark.parametrize("name", ["identity", "known_warp", "corpus_pair"])
def test_dtw_path_identical_to_jax(name, corpora):
    x, y = _dtw_case(name, corpora)
    jp = np.asarray(j_align.dtw_path(jnp.asarray(x), jnp.asarray(y)))
    tp = t_align.dtw_path(t32(x), t32(y))
    assert tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), jp)
    steps = np.diff(jp)
    assert jp[0] == 0 and jp[-1] == len(y) - 1
    assert steps.min() >= 0 and steps.max() <= 2
    if name == "identity":
        np.testing.assert_array_equal(jp, np.arange(len(x)))
    if name == "known_warp":
        np.testing.assert_allclose(y[jp], x, atol=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_dtw_path_cost_matches_jax(seed):
    """Random features: the port's path costs, under JAX's own cost
    matrix, within 1e-5 of JAX's path (float32 summation order may flip a
    near-tie, so the paths themselves may part)."""
    rng = np.random.default_rng(100 + seed)
    Fx, Fy = 40, 57           # one shape: one JAX compile for the 8 cases
    x = rng.standard_normal((Fx, 12)).astype(np.float32)
    y = rng.standard_normal((Fy, 12)).astype(np.float32)
    C = np.asarray(j_align.cost_matrix(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(t_align.cost_matrix(t32(x), t32(y)).numpy(),
                               C, rtol=1e-5, atol=1e-4)
    jp = np.asarray(j_align.dtw_path(jnp.asarray(x), jnp.asarray(y)))
    tp = t_align.dtw_path(t32(x), t32(y)).numpy()
    assert tp[0] == 0 and tp[-1] == Fy - 1
    assert np.diff(tp).min() >= 0 and np.diff(tp).max() <= 2
    cj, ct = t_align.path_cost(C, jp), t_align.path_cost(C, tp)
    assert abs(ct - cj) <= 1e-5 * abs(cj), (ct, cj)


def test_dtw_ties_take_fewest_steps_like_argmin():
    """Equal costs everywhere: every choice is a tie, which jnp.argmin
    settles on the first index (stay), so the path stays until it must
    advance by 2 per row to reach the end."""
    x = np.zeros((6, 3), np.float32)
    y = np.zeros((9, 3), np.float32)
    jp = np.asarray(j_align.dtw_path(jnp.asarray(x), jnp.asarray(y)))
    tp = t_align.dtw_path(t32(x), t32(y)).numpy()
    np.testing.assert_array_equal(tp, jp)


def test_batched_dtw_and_align_pair_match_jax(corpora):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 25, 6)).astype(np.float32)
    y = rng.standard_normal((3, 32, 6)).astype(np.float32)
    jb = np.asarray(j_align.batched_dtw_path(jnp.asarray(x), jnp.asarray(y)))
    tb = t_align.dtw_path(t32(x), t32(y)).numpy()
    np.testing.assert_array_equal(tb, jb)
    for b in range(3):
        np.testing.assert_array_equal(
            t_align.dtw_path(t32(x[b]), t32(y[b])).numpy(), jb[b])
    # align_pair on a corpus pair: every target feature warped by the path
    _, _, jdirs, _ = corpora
    d = _load(jdirs["prep_tr"] / "utt1.npz")
    tgt = {k: d[f"{k}_voc"] for k in FEATURES}
    ja = j_align.align_pair(jnp.asarray(d["mc_src"]), JFeature(
        **{k: jnp.asarray(v) for k, v in tgt.items()}))
    ta = t_align.align_pair(t32(d["mc_src"]), TFeature(
        **{k: t32(v) for k, v in tgt.items()}))
    for k in FEATURES:
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)))
    # the prepared file's aligned rows are that warp
    np.testing.assert_array_equal(ta.mc.numpy(), d["mc_tgt"])


# ---------------------------------------------------------------------------
# The formant corpus and its preparation
# ---------------------------------------------------------------------------

def test_build_formant_corpus_wavs_byte_identical(corpora):
    _, _, jdirs, tdirs = corpora
    n = 0
    for sub in ("src", "tgt", "ev_src", "ev_tgt"):
        jw = sorted(p.name for p in jdirs[sub].glob("*.wav"))
        assert jw == sorted(p.name for p in tdirs[sub].glob("*.wav"))
        for name in jw:
            assert ((tdirs[sub] / name).read_bytes()
                    == (jdirs[sub] / name).read_bytes()), (sub, name)
            n += 1
    assert n == 6


def _f0_agree(t, j):
    """test_dsp_golden.py's F0 gate: voicing agreement > 0.98 and p95
    error < 1 Hz on frames both call voiced."""
    assert ((t > 0) == (j > 0)).mean() > 0.98
    both = (t > 0) & (j > 0)
    if both.any():
        assert np.percentile(np.abs(t[both] - j[both]), 95) < 1.0


@pytest.mark.parametrize("prep", ["prep_tr", "prep_ev"])
def test_prepare_corpus_matches_jax(prep, corpora):
    """The same files and keys; the source features at the analysis
    tolerances of tests/test_torch_dsp.py; ``wave_voc`` verbatim; the F0
    statistics within 1e-5."""
    _, _, jdirs, tdirs = corpora
    jfiles = sorted(p.name for p in jdirs[prep].glob("*.npz"))
    assert jfiles == sorted(p.name for p in tdirs[prep].glob("*.npz"))
    for name in jfiles:
        j, t = _load(jdirs[prep] / name), _load(tdirs[prep] / name)
        assert list(t) == list(j), name
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        if name.startswith("stats_"):
            for k in ("mean", "std"):
                assert abs(float(t[k]) - float(j[k])) <= 1e-5 * abs(
                    float(j[k])), (name, k)
            continue
        np.testing.assert_array_equal(t["wave_voc"], j["wave_voc"])
        for side in ("src", "voc"):
            _f0_agree(t[f"f0_{side}"], j[f"f0_{side}"])
            same = (t[f"f0_{side}"] > 0) == (j[f"f0_{side}"] > 0)
            np.testing.assert_allclose(t[f"mc_{side}"][same],
                                       j[f"mc_{side}"][same], rtol=0,
                                       atol=1.2e-2)
            np.testing.assert_allclose(t[f"ap_{side}"][same],
                                       j[f"ap_{side}"][same], rtol=0,
                                       atol=2e-2)
            lj, lt = np.log(j[f"env_{side}"]), np.log(t[f"env_{side}"])
            hi = j[f"env_{side}"] >= j[f"env_{side}"].max(
                axis=1, keepdims=True) * 10.0 ** (-45.0 / 10.0)
            assert np.abs(lt - lj)[hi].max() < 0.05
            assert np.abs(lt - lj)[~hi].max(initial=0.0) < 0.17


def test_frame_bucket_and_paired_wavs(corpora, tmp_path):
    for n, b in ((1, 32), (32, 32), (33, 32), (120, 32), (0, 200)):
        assert t_corpus.frame_bucket(n, b) == j_corpus.frame_bucket(n, b)
    _, _, jdirs, _ = corpora
    assert (t_corpus.paired_wavs(str(jdirs["src"]), str(jdirs["tgt"]))
            == j_corpus.paired_wavs(str(jdirs["src"]), str(jdirs["tgt"])))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with pytest.raises(FileNotFoundError, match="no same-stem wav pairs"):
        t_corpus.prepare_corpus(str(tmp_path / "a"), str(tmp_path / "b"),
                                str(tmp_path / "o"), configs()[1],
                                device="cpu")


def test_cli_prepare_matches_prepare_corpus(corpora, tmp_path, capsys):
    _, tc, _, tdirs = corpora
    out = tmp_path / "prep"
    t_prepare_cli.main(["--src_dir", str(tdirs["src"]), "--tgt_dir",
                        str(tdirs["tgt"]), "--out_dir", str(out),
                        "--bucket_frames", "32", "--device", "cpu",
                        "--config_path", str(_tiny_yaml(tmp_path))])
    log = capsys.readouterr().out
    assert "[prepare] 2 pairs" in log and "F0 stats target" in log
    for p in sorted(tdirs["prep_tr"].glob("*.npz")):
        a, b = _load(p), _load(out / p.name)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


def _tiny_yaml(tmp_path) -> pathlib.Path:
    path = tmp_path / "tiny.yaml"
    path.write_text("acoustic: {hidden: 32, num_blocks: 2}\n"
                    "super_resolution: {hidden: 64, num_blocks: 2}\n"
                    "vocoder_nn: {hidden: 32, num_blocks: 2}\n"
                    "compute_dtype: float32\n")
    return path


# ---------------------------------------------------------------------------
# CorpusDataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [None, 1], ids=["eager", "lru"])
def test_corpus_dataset_batches_bit_equal_to_jax(cache, corpora):
    """Given the JAX-prepared dir and one seed, the port's batches equal
    JAX's bit for bit (crops that run past an utterance's end included:
    crop 140 > the 120 source frames), eagerly and through an LRU that
    stays within its bound."""
    jc, tc, jdirs, _ = corpora
    jd = j_dataset.CorpusDataset(str(jdirs["prep_tr"]), jc, crop_frames=140,
                                 seed=7, cache_utterances=cache)
    td = t_dataset.CorpusDataset(str(jdirs["prep_tr"]), tc, crop_frames=140,
                                 seed=7, cache_utterances=cache,
                                 device="cpu")
    assert td.num_utterances == jd.num_utterances == 2
    for _ in range(3):
        jb, tb = jd.sample_batch(3), td.sample_batch(3)
        for name, v in vars(tb).items():
            assert v.dtype == torch.float32 and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
        assert len(td._lru) == (0 if cache is None else 1)


def test_corpus_dataset_refuses_old_format(tmp_path):
    np.savez(tmp_path / "old.npz", f0_src=np.zeros(4, np.float32))
    for cache in (None, 2):
        with pytest.raises(KeyError, match="wave_voc"):
            t_dataset.CorpusDataset(str(tmp_path), configs()[1],
                                    cache_utterances=cache, device="cpu")
    with pytest.raises(FileNotFoundError, match="no pair npz"):
        t_dataset.CorpusDataset(str(tmp_path / "none"), configs()[1],
                                device="cpu")


# ---------------------------------------------------------------------------
# Metrics and the evaluation CLI
# ---------------------------------------------------------------------------

def test_mcd_and_f0_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 50, 25)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    f0a = rng.uniform(80, 300, 200).astype(np.float32)
    f0b = (f0a * rng.uniform(0.9, 1.1, 200)).astype(np.float32)
    f0a[rng.random(200) < 0.2] = 0.0
    f0b[rng.random(200) < 0.2] = 0.0
    np.testing.assert_allclose(
        float(t_evaluate.mcd_db(t32(a), t32(b))),
        float(j_evaluate.mcd_db(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    tm = t_evaluate.f0_metrics(t32(f0a), t32(f0b))
    jm = j_evaluate.f0_metrics(jnp.asarray(f0a), jnp.asarray(f0b))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    # no frame voiced in both: the JAX package's guard, RMSE 0
    z = t_evaluate.f0_metrics(t32(np.zeros(4)), t32(f0b[:4]))
    assert float(z["logf0_rmse"]) == 0.0


def test_cli_evaluate_prints_jax_keys(corpora, capsys):
    """Both evaluation CLIs on one pair of wavs: the same JSON keys, the
    same frame count, and the metrics at the analysis tolerances."""
    _, _, jdirs, _ = corpora
    argv = ["--converted_path", str(jdirs["src"] / "utt0.wav"),
            "--target_path", str(jdirs["src"] / "utt1.wav")]
    j_eval_cli.main(argv)
    j_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_eval_cli.main(argv + ["--device", "cpu"])
    t_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(t_out) == list(j_out)
    assert t_out["frames"] == j_out["frames"]
    assert abs(t_out["mcd_db"] - j_out["mcd_db"]) < 0.05
    assert abs(t_out["logf0_rmse"] - j_out["logf0_rmse"]) < 0.01


def test_corpus_entry_points_never_fall_back_to_cpu(corpora, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, tc, _, tdirs = corpora
    calls = [
        lambda: t_corpus.analyze_file(tdirs["src"] / "utt0.wav", tc),
        lambda: t_corpus.prepare_corpus(str(tdirs["src"]),
                                        str(tdirs["tgt"]),
                                        str(tmp_path / "o"), tc),
        lambda: t_dataset.CorpusDataset(str(tdirs["prep_tr"]), tc),
        lambda: t_data.build_formant_corpus(tmp_path / "c", tc),
        lambda: t_fc.train_plain(tc, tdirs["prep_tr"], steps=1),
        lambda: t_fc.converted_pairs({}, tc, tdirs["prep_tr"]),
        lambda: t_fc.conditioning_gap({}, tc, {}),
        lambda: t_fc.full_chain_metrics({}, tc, np.zeros(10), {}),
        lambda: t_fc.finetune_vocoder_on_converted({}, tc, [], steps=1),
        lambda: t_prepare_cli.main(["--src_dir", "a", "--tgt_dir", "b",
                                    "--out_dir", "c"]),
        lambda: t_eval_cli.main(["--converted_path", "a",
                                 "--target_path", "b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
