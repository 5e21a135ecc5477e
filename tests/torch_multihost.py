"""Multi-process runs of the PyTorch port for the tests
(``tests/test_torch_multihost_*.py``), and the worker they start.

``run_ranks`` starts ``world`` worker processes of this file that join one
gloo process group over loopback (``parallel/multihost.py``), each on the
CPU with one thread, and waits for them with a timeout; a worker that
fails or hangs fails the test.  The same worker at ``world=1`` is each
reference, so both sides run in the same setting.  The config (a JSON
dict for the port's ``Config.from_dict``), the weights (the JAX ``.npz``
layout) and any batch are files the test writes into the run's directory;
each worker writes its results there as ``<mode>_<tag>_<rank>.npz``.

The worker imports torch and the port only.

    python tests/torch_multihost.py MODE RANK WORLD PORT DIR OPTS_JSON
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 120            # one worker run, start-up included
GROUP_TIMEOUT_S = 60       # a collective that waits longer raises


_PORTS: set[int] = set()


def free_port() -> int:
    """A free loopback port not handed out before in this process (runs
    started together would otherwise race for a port just released)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _PORTS:
            _PORTS.add(port)
            return port


def start_ranks(run_dir, mode: str, world: int, **opts) -> list:
    """Start the ``mode`` worker at ``world`` ranks (:func:`wait_ranks`
    collects them)."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(world), str(port),
         str(run_dir), json.dumps(opts)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(),
        text=True) for r in range(world)]


def wait_ranks(*runs) -> list[list[str]]:
    """Wait for the runs :func:`start_ranks` or :func:`start_cli` started;
    returns each run's outputs by rank.  Raises when a rank exits non-zero
    or outlasts TIMEOUT_S; kills what is left."""
    try:
        return [_wait(procs, "run") for procs in runs]
    finally:
        for p in (p for procs in runs for p in procs):
            if p.poll() is None:
                p.kill()
                p.wait()


def run_ranks(run_dir, mode: str, world: int, **opts) -> None:
    """Run the ``mode`` worker at ``world`` ranks and wait for it."""
    wait_ranks(start_ranks(run_dir, mode, world, **opts))


def _env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO)] + [p for p in os.environ.get(
                        "PYTHONPATH", "").split(os.pathsep) if p]))


def _wait(procs, what: str) -> list[str]:
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"{what} rank {r}/{len(procs)} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def start_cli(module: str, argv: list[str], world: int,
              via_env: bool = False) -> list:
    """Start ``python -m module argv`` at ``world`` ranks on the CPU, the
    launch given as the three flags or (``via_env``) as the JAX package's
    environment names."""
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(world):
        env, extra = _env(), []
        if via_env:
            env.update(JAX_COORDINATOR_ADDRESS=coord,
                       JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r))
        else:
            extra = ["--coordinator_address", coord, "--num_processes",
                     str(world), "--process_id", str(r)]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True, cwd=REPO))
    return procs


def run_cli(module: str, argv: list[str], world: int) -> list[str]:
    """``python -m module argv`` at ``world`` ranks (the launch flags
    added); returns each rank's output."""
    return wait_ranks(start_cli(module, argv, world))[0]


def load(run_dir, mode: str, tag: str, rank: int) -> dict:
    with np.load(pathlib.Path(run_dir) / f"{mode}_{tag}_{rank}.npz") as f:
        return dict(f)


def make_schedule(n: int, S: int, ticks: int):
    """Per-(slot, tick) chunks and live / reset masks
    (tests/test_multihost_serving.py's schedule): slot 1 pauses at tick
    2, slot n - 2 rejoins (reset) at tick 3."""
    rng = np.random.default_rng(1234)
    chunks = 0.3 * np.sin(
        2 * np.pi
        * (120.0 + 17.0 * np.arange(n))[:, None, None]
        * (np.arange(ticks * S, dtype=np.float64) / 24000.0)
        .reshape(ticks, S)[None]).astype(np.float32)
    chunks += 0.01 * rng.standard_normal((n, ticks, S)).astype(np.float32)
    live = np.ones((ticks, n), bool)
    live[2, 1] = False
    reset = np.zeros((ticks, n), bool)
    reset[3, n - 2] = True
    return chunks, live, reset


def socket_signal(rank: int, fs: int) -> np.ndarray:
    """The client signal of rank ``rank``'s client
    (tests/test_multihost_socket.py's)."""
    t = np.arange(int(0.4 * fs)) / fs
    return (0.3 * np.sin(2 * np.pi * (130.0 + 40.0 * rank) * t)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def _serve(cfg, params, mesh, opts) -> dict:
    from realtime_yukarin_tpu_torch.parallel.serving import (
        BatchedServer, model_stage_flops)
    server = BatchedServer(params, cfg, num_streams=opts["n"], mesh=mesh,
                           device="cpu")
    n, S = server.num_streams, server.chunk_samples
    lo, hi = server.local_slots.start, server.local_slots.stop
    chunks, live, reset = make_schedule(n, S, opts["ticks"])
    outs = [server.step_local(chunks[lo:hi, k], live=live[k, lo:hi],
                              reset=reset[k, lo:hi])
            for k in range(opts["ticks"])]
    # this rank's count of one step (collective over a model group)
    step_cost = server.step_cost_analysis()
    return {"out": np.stack(outs), "range": np.asarray([lo, hi]),
            "num_streams": np.asarray(n),
            "flops": np.asarray(step_cost["flops"]),
            "bytes": np.asarray(step_cost["bytes accessed"]),
            "model_flops": np.asarray(
                sum(model_stage_flops(server).values()))}


def _socket(cfg, params, mesh, opts, world: int) -> dict:
    from realtime_yukarin_tpu_torch.runtime.socket_server import (
        SocketVoiceServer, convert_over_socket)
    fs = cfg.dsp.in_rate
    with SocketVoiceServer(params, cfg, num_streams=opts["n"],
                           device="cpu", mesh=mesh) as srv:
        lo = srv._server.local_slots.start
        if srv.address is None:
            # a model group's following rank: it steps with the first
            # rank's rows until that rank closes
            return {"lo": np.asarray(lo)}
        if world > 1:
            y = convert_over_socket(*srv.address,
                                    socket_signal(mesh.rank, fs))
            return {"out": y, "lo": np.asarray(lo)}
        # one rank: client 0 on slot 0, then four idle connections parked
        # on slots 0-3 so that client 1 lands on the global slot the
        # second rank's first slot is (n / 2)
        ref0 = convert_over_socket(*srv.address, socket_signal(0, fs))
        deadline = time.time() + 60
        while (any(s.active for s in srv._slots)
               and time.time() < deadline):
            time.sleep(0.02)
        parked = [socket.create_connection(srv.address)
                  for _ in range(opts["n"] // 2)]
        while (sum(s.active for s in srv._slots) < opts["n"] // 2
               and time.time() < deadline):
            time.sleep(0.02)
        ref1 = convert_over_socket(*srv.address, socket_signal(1, fs))
        for s in parked:
            s.close()
        return {"out0": ref0, "out1": ref1}


def _flax(trees: dict, leaves: dict, mesh) -> dict:
    """{flax name: whole array} of per-leaf tensors ``leaves`` (a
    gradient, or the leaves themselves) of the params trees ``trees``
    ({name prefix: params dict}): model shards gathered (every rank of the
    model group takes part), kernels in flax's axis order."""
    import torch

    from realtime_yukarin_tpu_torch.models.voice_changer import (
        F0_STAT_NAMES, flax_tensors, param_leaves)
    from realtime_yukarin_tpu_torch.parallel.mesh import (gather_model,
                                                          sharded_leaf_ids)
    names = {}
    for key, tree in trees.items():
        for stage, v in tree.items():
            if isinstance(v, torch.nn.Module):
                for path, t in flax_tensors(v).items():
                    names[id(t)] = f"{key}{stage}/params/{path}"
            else:
                for n in F0_STAT_NAMES:
                    names[id(v[n])] = f"{key}{stage}/{n}"
    out = {}
    for key, tree in trees.items():
        split = sharded_leaf_ids(tree)
        for stage, ps in param_leaves(tree).items():
            for p, g in zip(ps, leaves[key][stage]):
                g = gather_model(g.detach(), mesh, 0) if id(p) in split \
                    else g.detach()
                a = g.numpy().copy()
                name = names[id(p)]
                out[name] = np.transpose(a) if name.endswith("/kernel") \
                    else a
    return out


DISC = "disc/"


def _state_trees(state, gan: bool) -> dict:
    trees = {"": state.params}
    if gan:
        trees[DISC] = {"d": state.d_params}
    return trees


def _train(cfg, params, mesh, opts, run_dir) -> dict:
    """Both objectives, ``opts["steps"]`` steps each, on this rank's rows
    of ``batch.npz``: each step's metrics and the state it starts from,
    and the gradients at that state, or, given ``opts["ref"]`` (a
    one-rank run's tag), at the state the reference run started that step
    from.  Then the trained generator."""
    import torch

    from realtime_yukarin_tpu_torch.models.discriminator import (
        EnvelopeDiscriminator, init_discriminator)
    from realtime_yukarin_tpu_torch.models.voice_changer import (
        load_flax, param_leaves, params_from_jax, params_to_jax)
    from realtime_yukarin_tpu_torch.parallel.mesh import gather_params
    from realtime_yukarin_tpu_torch.training import train_step as ts

    with np.load(run_dir / "batch.npz") as f:
        rows = len(f["f0_src"]) // mesh.data_size
        lo = mesh.data_index * rows
        batch = ts.Batch(**{k: torch.from_numpy(f[k][lo: lo + rows])
                            for k in f.files})
    ref = load(run_dir, "train", opts["ref"], 0) if opts.get("ref") else None
    disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                              torch.Generator().manual_seed(1))

    def ref_state(objective: str, k: int, shard):
        pre = f"{objective}/{k}/state/"
        flat = {n[len(pre):]: v for n, v in ref.items() if n.startswith(pre)}
        p = params_from_jax({n: v for n, v in flat.items()
                             if not n.startswith(DISC)}, cfg)
        if objective == "joint":
            return shard(ts.init_train_state(p, "cpu"))
        d = EnvelopeDiscriminator(cfg.dsp.spec_bins)
        load_flax(d, {n[len(DISC) + 2:]: v for n, v in flat.items()
                      if n.startswith(DISC)})
        return shard(ts.init_gan_train_state(p, d, "cpu"))

    out = {}
    for objective in ("joint", "gan"):
        gan = objective == "gan"
        if gan:
            step, shard = ts.make_sharded_gan_step(cfg, mesh)
            state = shard(ts.init_gan_train_state(params, disc, "cpu"))
        else:
            step, shard = ts.make_sharded_train_step(cfg, mesh)
            state = shard(ts.init_train_state(params, "cpu"))
        for k in range(opts["steps"]):
            pre = f"{objective}/{k}/"
            trees = _state_trees(state, gan)
            out.update({pre + "state/" + n: v for n, v in _flax(
                trees, {key: param_leaves(t) for key, t in trees.items()},
                mesh).items()})
            at = state if ref is None else ref_state(objective, k, shard)
            if gan:
                _, g, d = ts.gan_losses_and_grads(at, batch, cfg, mesh=mesh)
                grads = {"": g, DISC: {"d": d["params"]}}
            else:
                _, g = ts.loss_and_grads(at.params, batch, cfg, mesh)
                grads = {"": g}
            out.update({pre + "grad/" + n: v for n, v in _flax(
                _state_trees(at, gan), grads, mesh).items()})
            state, metrics = step(state, batch)
            out.update({pre + "loss/" + n: np.asarray(float(v))
                        for n, v in metrics.items()})
        final = gather_params(mesh, state.params)
        out.update({f"{objective}/param/{n}": v
                    for n, v in params_to_jax(final).items()})
    return out


def worker(mode: str, rank: int, world: int, port: int, run_dir: str,
           opts: dict) -> None:
    import torch

    torch.set_num_threads(1)
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.models.voice_changer import (
        load_params_npz)
    from realtime_yukarin_tpu_torch.parallel.mesh import make_mesh
    from realtime_yukarin_tpu_torch.parallel.multihost import (
        init_multihost, sync_hosts)

    run_dir = pathlib.Path(run_dir)
    got = init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                         timeout_s=GROUP_TIMEOUT_S)
    assert got == (rank, world), got
    cfg = Config.from_dict(json.loads((run_dir / "config.json").read_text()))
    params = load_params_npz(str(run_dir / "params.npz"), cfg)
    mesh = make_mesh(opts.get("model_parallel", 1))
    if mode == "serve":
        out = _serve(cfg, params, mesh, opts)
    elif mode == "socket":
        out = _socket(cfg, params, mesh, opts, world)
    elif mode == "train":
        out = _train(cfg, params, mesh, opts, run_dir)
    else:
        raise ValueError(mode)
    np.savez(run_dir / f"{mode}_{opts['tag']}_{rank}.npz", **out)
    sync_hosts()
    if world > 1:
        torch.distributed.destroy_process_group()
    print("OK", rank, flush=True)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5], json.loads(sys.argv[6]))
