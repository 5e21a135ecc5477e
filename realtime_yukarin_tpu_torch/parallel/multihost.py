"""Multi-process bring-up over ``torch.distributed`` (PyTorch port of
``parallel/multihost.py``).

The JAX package runs N hosts as one program: ``jax.distributed`` wires
the processes into one runtime and GSPMD inserts the collectives.  The
port runs one process per GPU instead (one rank per card) over
``torch.distributed``: NCCL between cards, gloo on the CPU and for ranks
that share a card.  Every rank runs the same command; the three launch
arguments come from the caller or from the JAX package's environment names
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so one launch script drives both packages.

The JAX package's ``host_local_to_global``, ``put_global`` and
``host_local_rows`` move between JAX global arrays and host-local data.  A
torch rank already holds its local tensors (its batch rows, its lanes, its
parameter shards), so they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

# long enough for host-0-only work (a fine-tune, a checkpoint) that the
# other ranks wait for at their next collective; finite, so a lost partner
# fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 1800.0


def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None,
                   device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S
                   ) -> tuple[int, int]:
    """Join the process group when running multi-process; no-op otherwise.

    Returns (rank, world).  Only an explicit ``num_processes=1`` (or no
    coordinator at all) is a single process: a coordinator without a
    process count or id raises, since torch cannot detect the topology and
    running on alone would train an independent model with no error.

    The backend is NCCL for a ``cuda`` device and gloo for ``cpu``; pass
    ``backend="gloo"`` for ranks that share one card (NCCL refuses two
    ranks on one device).  A failure to join is raised, never replaced by
    another backend.  A rank's card is ``cuda:(rank % device_count)``
    (:func:`rank_device`), made current here.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = (num_processes if num_processes is not None
             else _env_int("JAX_NUM_PROCESSES"))
    pid = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")
    if coord is None or nproc == 1:
        return 0, 1
    if nproc is None or pid is None:
        raise ValueError(f"coordinator {coord} given without the process "
                         f"count and id (num_processes={nproc}, "
                         f"process_id={pid}); torch.distributed cannot "
                         f"detect them")
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id {pid} outside [0, {nproc})")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        card = torch.device("cuda", pid % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            kwargs["device_id"] = card     # NCCL joins eagerly, so a
            #                                duplicate card fails here
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` for ``cuda``,
    the device as given otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda",
                        process_index() % torch.cuda.device_count())


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy on this rank's card when the group is NCCL (which
    moves CUDA tensors only)."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _broadcast_tensor_(t: torch.Tensor) -> None:
    src = t.detach()
    buf = _staged(src).contiguous()
    dist.broadcast(buf, src=0)
    if buf.data_ptr() != src.data_ptr():
        src.copy_(buf)


def broadcast_from_host0(tree):
    """Rank 0's value of ``tree`` on every rank (no-op single-process).

    Tensors, modules' parameters and buffers and an optimizer's state
    tensors are overwritten in place; numpy arrays and Python numbers are
    returned anew; dicts, lists, tuples and dataclasses are walked.  Every
    rank passes the same structure (an optimizer's state included: see
    ``training.train_step.ensure_optimizer_state``)."""
    if process_count() == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        _broadcast_tensor_(tree)
        return tree
    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            _broadcast_tensor_(t)
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        for group in tree.param_groups:
            for p in group["params"]:
                for v in tree.state[p].values():
                    if isinstance(v, torch.Tensor):
                        _broadcast_tensor_(v)
        return tree
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tree)).clone()
        _broadcast_tensor_(t)
        return t.numpy()
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        t = torch.tensor(tree, dtype=torch.float64 if isinstance(tree, float)
                         else torch.int64)
        _broadcast_tensor_(t)
        return type(tree)(t.item())
    if isinstance(tree, dict):
        return {k: broadcast_from_host0(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_host0(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            setattr(tree, f.name, broadcast_from_host0(getattr(tree, f.name)))
        return tree
    raise TypeError(f"cannot broadcast a {type(tree).__name__}")


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across ranks (no-op single-process).  ``name`` is kept for
    the JAX package's signature."""
    del name
    if process_count() > 1:
        dist.barrier()


def global_batch_size(per_host_batch: int) -> int:
    return per_host_batch * process_count()
