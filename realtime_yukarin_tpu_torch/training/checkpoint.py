"""Checkpoint / resume for training state (PyTorch port of
``training/checkpoint.py``).

The whole ``TrainState`` / ``GanTrainState`` (parameters, optimizer state,
step, and for the GAN the discriminator and the EMA generator) round-trips
through one ``torch.save`` file, read back with ``weights_only=True``.
Restore loads into a template state (from init), which validates the
structure: every module loads strictly, a missing or extra key raises.
It writes into the template's own tensors, the optimizers' moments and
step counts included, so a step captured over the template
(``training/train_step.py:StepProgram``) reads the restored state.

Layout: ``<dir>/ckpt_<step>.pt`` with a ``latest`` pointer file; ``keep``
bounds retention.

Over several ranks (:func:`save_checkpoint_from_host0`,
:func:`restore_checkpoint_to_all`) a checkpoint holds the whole state:
rank 0 writes it after the model split is gathered, and on resume every
rank takes rank 0's state, step and optimizer moments by broadcast, so no
shared file system is needed.
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch
import torch.nn as nn

from realtime_yukarin_tpu_torch.parallel.multihost import (
    broadcast_from_host0, process_count)
from realtime_yukarin_tpu_torch.training.train_step import (
    ensure_optimizer_state, gather_train_state)


def _step_of(path: pathlib.Path) -> int:
    return int(path.stem.split("_")[1])


def _to_saved(value):
    if isinstance(value, (nn.Module, torch.optim.Optimizer)):
        return value.state_dict()
    if isinstance(value, dict):
        return {k: _to_saved(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.detach()
    return value


def _load_optimizer(opt: torch.optim.Optimizer, saved: dict) -> None:
    """``opt.load_state_dict(saved)`` (which checks the structure and puts
    each state tensor where ``opt``'s policy wants it, e.g. a
    ``capturable`` step count on the device), then each loaded state
    tensor copied into the one ``opt`` held before, which goes back in its
    place: the tensors' addresses stay."""
    ensure_optimizer_state(opt)
    held = {p: dict(st) for p, st in opt.state.items()}
    opt.load_state_dict(saved)
    with torch.no_grad():
        for p, st in opt.state.items():
            for k, v in st.items():
                old = held.get(p, {}).get(k)
                if (isinstance(old, torch.Tensor)
                        and old.shape == v.shape and old.dtype == v.dtype):
                    st[k] = old.copy_(v)


def _load_into(template, saved, where: str):
    """``saved`` loaded into ``template`` (in place where it holds
    tensors); returns the value to keep."""
    if isinstance(template, torch.optim.Optimizer):
        _load_optimizer(template, saved)
        return template
    if isinstance(template, nn.Module):
        template.load_state_dict(saved)
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"checkpoint structure mismatch at {where}: "
                             f"{sorted(template)} vs "
                             f"{sorted(saved) if isinstance(saved, dict) else type(saved).__name__}")
        return {k: _load_into(v, saved[k], f"{where}/{k}")
                for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"shape mismatch at {where}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    return type(template)(saved)


def save_checkpoint(ckpt_dir: str | pathlib.Path, state, step: int,
                    keep: int = 3) -> pathlib.Path:
    """Write ``state`` as ``ckpt_<step>.pt`` (atomically), point ``latest``
    at it and keep the newest ``keep`` checkpoints."""
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"ckpt_{step}.pt"
    tmp = d / f"tmp_ckpt_{step}.pt"
    torch.save({f.name: _to_saved(getattr(state, f.name))
                for f in dataclasses.fields(state)}, tmp)
    tmp.rename(path)                       # atomic publish
    (d / "latest").write_text(path.name)
    old = sorted(d.glob("ckpt_*.pt"), key=_step_of)
    for p in old[:-keep]:
        p.unlink()
    return path


def latest_checkpoint(ckpt_dir: str | pathlib.Path) -> pathlib.Path | None:
    d = pathlib.Path(ckpt_dir)
    pointer = d / "latest"
    if pointer.exists():
        p = d / pointer.read_text().strip()
        if p.exists():
            return p
    cands = sorted(d.glob("ckpt_*.pt"), key=_step_of)
    return cands[-1] if cands else None


def restore_checkpoint(ckpt_dir: str | pathlib.Path, template):
    """Restore the newest checkpoint into ``template`` (in place).
    Returns (state, step) or (template, 0) when no checkpoint exists."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return template, 0
    saved = torch.load(path, map_location="cpu", weights_only=True)
    names = [f.name for f in dataclasses.fields(template)]
    if set(saved) != set(names):
        raise ValueError(f"{path}: fields {sorted(saved)}, expected "
                         f"{sorted(names)}")
    for name in names:
        setattr(template, name, _load_into(getattr(template, name),
                                           saved[name], name))
    return template, _step_of(path)


def save_checkpoint_from_host0(ckpt_dir: str | pathlib.Path, state, step: int,
                               mesh, keep: int = 3) -> pathlib.Path | None:
    """Gather ``state``'s model split (collective: every rank calls this),
    then rank 0 writes it.  Returns the path on rank 0, None elsewhere."""
    full = gather_train_state(mesh, state)
    if mesh.rank != 0:
        return None
    return save_checkpoint(ckpt_dir, full, step, keep)


def restore_checkpoint_to_all(ckpt_dir: str | pathlib.Path, template):
    """:func:`restore_checkpoint` on every rank (a rank that finds no
    checkpoint keeps ``template``), then rank 0's state, step and
    optimizer moments on all of them.  ``template`` is the whole (not yet
    sharded) state.  Returns (state, step)."""
    state, step = restore_checkpoint(ckpt_dir, template)
    if process_count() > 1:
        for name in ("opt", "d_opt"):
            if hasattr(state, name):
                ensure_optimizer_state(getattr(state, name))
        state = broadcast_from_host0(state)
        step = broadcast_from_host0(step)
    return state, step
