"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same Config (the port's built from the JAX one's
dict), the same weights (the JAX init perturbed with seeded numpy noise,
so the zero-initialised heads are active) and the same inputs, passed as
numpy arrays.  JAX stays on the CPU (tests/conftest.py).
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from realtime_yukarin_tpu.models.voice_changer import (flatten_params,
                                                       init_params,
                                                       unflatten_params)
from realtime_yukarin_tpu_torch.config import Config as TorchConfig
from realtime_yukarin_tpu_torch.models.voice_changer import params_from_jax
from realtime_yukarin_tpu_torch.training import data as t_data

from conftest import tiny_config

# every network subtree: perturbing all of them activates the zero-init
# heads of both stages and both neural vocoders
ALL_NETS = ("stage1/", "stage2/", "vocoder/", "vocoder_wave/")


def configs(cfg=None):
    """(JAX Config, port Config) with float32 models; the tiny model
    config unless ``cfg`` is given."""
    jc = dataclasses.replace(cfg if cfg is not None else tiny_config(),
                             compute_dtype="float32")
    return jc, TorchConfig.from_dict(jc.to_dict())


def training_configs():
    """(JAX Config, port Config): the tiny model config with the wave
    vocoder shrunk too (hidden 32, 2 blocks, P = 4, Q = 2), float32."""
    from realtime_yukarin_tpu.config import VocoderWaveConfig
    return configs(dataclasses.replace(
        tiny_config(), vocoder_wave=VocoderWaveConfig(
            hidden=32, num_blocks=2, phase_harmonics=4,
            phase_fractional=2)))


def perturbed_params(jc, tc, seed: int = 1, scale: float = 0.02,
                     prefixes=("stage1/", "stage2/")):
    """(JAX params, port params, flat npz dict): the JAX init with every
    leaf under ``prefixes`` perturbed by seeded gaussian noise, carried to
    the port."""
    template = init_params(jax.random.key(0), jc)
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
            if k.startswith(prefixes) else v
            for k, v in flatten_params(template).items()}
    jp = unflatten_params(template, flat)
    tp = params_from_jax(flat, tc)
    return jp, tp, flat


def t32(a) -> torch.Tensor:
    """A CPU float32 tensor from a numpy or JAX array."""
    return torch.from_numpy(np.array(a, np.float32))


def rel_to_peak(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@contextlib.contextmanager
def jax_references_jitted():
    """Within the block, the JAX package's functions that its corpus and
    full-chain code call eagerly run under ``jax.jit``: ``analyze`` (whose
    docstring fixes its shapes for jit), ``convert_features``, the
    conditioning gap's ``_vocode`` and ``multi_resolution_stft``.  The
    functions and their results are the JAX package's (float32 rounding
    apart: a jitted analysis lies within ~1e-6 of the peak of the eager
    one on the CPU); jit compiles each once per shape where eager dispatch
    compiles every primitive (one eager analysis takes ~12 s on the CPU,
    a jitted one ~2 s).  The names are restored on exit, and the stream's
    memoised silence analysis is cleared on both sides of the block."""
    from realtime_yukarin_tpu.cli import evaluate as j_eval_cli
    from realtime_yukarin_tpu.dsp import world
    from realtime_yukarin_tpu.models import voice_changer as j_vc
    from realtime_yukarin_tpu.streaming import state
    from realtime_yukarin_tpu.training import corpus, full_chain, losses

    analyze = jax.jit(world.analyze,
                      static_argnames=("num_frames", "cfg", "center_offset"))
    state._silence_features.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (world, corpus, full_chain, j_eval_cli):
            mp.setattr(mod, "analyze", analyze)
        mp.setattr(full_chain, "convert_features",
                   jax.jit(j_vc.convert_features,
                           static_argnames=("cfg", "use_sr", "dtype")))
        mp.setattr(full_chain, "_vocode",
                   jax.jit(full_chain._vocode,
                           static_argnames=("cfg", "mode")))
        mp.setattr(losses, "multi_resolution_stft",
                   jax.jit(losses.multi_resolution_stft,
                           static_argnames=("ffts",)))
        try:
            yield
        finally:
            state._silence_features.cache_clear()


@pytest.fixture(scope="module")
def jax_jitted():
    """A module's tests under :func:`jax_references_jitted`."""
    with jax_references_jitted():
        yield


_CORPORA: dict = {}


def port_formant_corpus(tmp_path_factory, tc) -> dict:
    """The port's formant corpus at 2 training pairs (plus the held-out
    pair), prepared on the CPU at its bucket: built once per process for
    every module that asks with the same DSP config.  Returns
    ``build_formant_corpus``'s dirs."""
    if tc.dsp not in _CORPORA:
        _CORPORA[tc.dsp] = t_data.build_formant_corpus(
            tmp_path_factory.mktemp("formant_corpus"), tc, n_train=2,
            device="cpu")
    return _CORPORA[tc.dsp]
