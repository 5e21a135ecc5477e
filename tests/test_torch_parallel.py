"""The port's data x model layout (``parallel/mesh.py``,
``parallel/multihost.py``) in one process: the shard rule picks the JAX
package's leaves, ``BatchedServer`` rounds ``num_streams`` to the data
ranks and hands each rank its slot range as the JAX server does, and the
multi-process helpers are no-ops at one process
(``tests/test_parallel.py``'s counterparts).  The multi-process runs are
``tests/test_torch_multihost_*.py``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from realtime_yukarin_tpu.config import Config as JConfig
from realtime_yukarin_tpu.models.discriminator import (
    init_discriminator as j_init_discriminator)
from realtime_yukarin_tpu.models.voice_changer import (flatten_params,
                                                       init_params as j_init)
from realtime_yukarin_tpu.parallel.mesh import make_mesh as j_make_mesh
from realtime_yukarin_tpu.parallel.mesh import (
    model_shard_specs as j_model_shard_specs)
from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.models.discriminator import (
    EnvelopeDiscriminator)
from realtime_yukarin_tpu_torch.models.voice_changer import stage_nets
from realtime_yukarin_tpu_torch.parallel import multihost
from realtime_yukarin_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                      model_shard_specs,
                                                      shard_params)
from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
from realtime_yukarin_tpu_torch.training import train_step as ts
from realtime_yukarin_tpu_torch.training.data import make_batch

from conftest import tiny_config
from torch_parity import configs, perturbed_params, training_configs

LAUNCH_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID")


def _jax_split(tree, model_parallel: int) -> set[str]:
    """The flax names the JAX rule splits over ``model``, from shapes
    alone (``jax.eval_shape``: no weights are made)."""
    specs = j_model_shard_specs(j_make_mesh(model_parallel=model_parallel),
                                tree)
    marks = jax.tree.map(lambda s: np.asarray(len(s) > 0 and s[-1] == "model"),
                         specs, is_leaf=lambda x: isinstance(x, P))
    return {n for n, v in flatten_params(marks).items() if v}


@pytest.mark.parametrize("model_parallel", [2, 4])
@pytest.mark.parametrize("which", ["tiny", "default"])
def test_shard_rule_picks_the_jax_leaves(which, model_parallel):
    """Every subtree's kernels, the discriminator's too: the port splits
    exactly the leaves the JAX rule splits (each shape read in the JAX
    ``.npz`` layout), biases never."""
    jc = tiny_config() if which == "tiny" else JConfig()
    tc = Config.from_dict(jc.to_dict())
    key = jax.random.key(0)
    j_params = jax.eval_shape(lambda: j_init(key, jc))
    j_disc = jax.eval_shape(lambda: j_init_discriminator(
        key, jc.super_resolution, jc.dsp)[1])
    mesh = Mesh(rank=0, world=model_parallel, model_parallel=model_parallel)
    port = model_shard_specs(mesh, stage_nets(tc))
    assert {n for n, s in port.items() if s} == _jax_split(j_params,
                                                            model_parallel)
    disc = model_shard_specs(mesh, EnvelopeDiscriminator(tc.dsp.spec_bins))
    assert {n for n, s in disc.items() if s} == _jax_split(j_disc,
                                                            model_parallel)
    assert not any(s for n, s in port.items() if n.endswith("/bias"))
    assert any(port.values())


def test_shard_params_keeps_this_ranks_output_channels():
    """Rank 3 of 4 model ranks holds the last quarter of each selected
    weight's output channels (torch's dim 0), the rest is untouched, and
    the caller's modules are left whole."""
    _, tc = configs()
    nets = stage_nets(tc)
    mesh = Mesh(rank=3, world=4, model_parallel=4)
    split = shard_params(mesh, nets)
    conv = nets["stage1"].blocks[0].conv
    part = split["stage1"].blocks[0].conv
    n = conv.weight.shape[0] // 4
    assert torch.equal(part.weight, conv.weight[3 * n:])
    assert torch.equal(part.bias, conv.bias)
    assert part.model_shard is mesh and not hasattr(conv, "model_shard")
    head = split["vocoder"].harm_head        # 161 channels: replicated
    assert head.weight.shape == nets["vocoder"].harm_head.weight.shape


@pytest.mark.parametrize("world,requested,rounded", [(8, 5, 8), (8, 8, 8),
                                                      (3, 8, 9), (1, 5, 5)])
def test_num_streams_rounds_and_local_slots(world, requested, rounded):
    """num_streams rounds up to the data ranks, as the JAX server rounds
    to its data devices (5 -> 8 at 8, tests/test_parallel.py); rank r
    serves the contiguous slots
    [r * N / D, (r + 1) * N / D), keeps the global lane keys of them, and
    at model_parallel 1 steps its own rows without any collective.  A
    one-rank-only call refuses at more than one rank."""
    _, tc = configs()
    params = perturbed_params(*configs())[1]
    n_local = rounded // world
    for rank in sorted({0, world - 1}):
        server = BatchedServer(params, tc, num_streams=requested,
                               device="cpu",
                               mesh=Mesh(rank=rank, world=world,
                                         model_parallel=1))
        assert server.num_streams == rounded
        assert server.local_slots == range(rank * n_local,
                                           (rank + 1) * n_local)
        whole = BatchedServer(params, tc, num_streams=rounded, device="cpu",
                              mesh=Mesh(rank=0, world=1, model_parallel=1))
        assert torch.equal(server._keys,
                           whole._keys[server.local_slots.start:
                                       server.local_slots.stop])
        out = server.step_local(np.zeros((n_local, server.chunk_samples),
                                         np.float32))
        assert out.shape == (n_local, server.chunk_out_samples)
        if world > 1:
            with pytest.raises(RuntimeError, match="step_local"):
                server.step(np.zeros((n_local, server.chunk_samples),
                                     np.float32))
            with pytest.raises(RuntimeError, match="step_local"):
                server.reset_stream(0)


def test_multihost_helpers_single_process(monkeypatch):
    """At one process, as tests/test_parallel.py's helpers test holds: the
    bring-up is a no-op (also with a coordinator and an explicit one
    process, by argument or environment), the barrier and the broadcast
    are no-ops, the global batch is the local one, the mesh is one data
    rank (model_parallel 2 refuses), and the sharded train step takes a
    step whose loss is the plain step's."""
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_multihost() == (0, 1)
    assert multihost.init_multihost("127.0.0.1:1", 1, 0) == (0, 1)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert multihost.init_multihost(device="cpu") == (0, 1)
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.init_multihost(device="cpu")
    assert multihost.global_batch_size(4) == 4
    multihost.sync_hosts("test")
    tree = {"a": np.arange(3), "b": 2.5, "c": torch.ones(2)}
    assert multihost.broadcast_from_host0(tree) is tree
    assert multihost.rank_device("cpu") == torch.device("cpu")

    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(model_parallel=2)

    jc, tc = training_configs()
    params = perturbed_params(jc, tc)[1]
    batch = make_batch(tc, 2, seconds=0.1, seed=0, device="cpu")
    step, shard = ts.make_sharded_train_step(tc, mesh)
    state = shard(ts.init_train_state(params, "cpu"))
    _, m = step(state, batch)
    plain = ts.init_train_state(params, "cpu")
    _, m0 = ts.make_train_step(tc)(plain, batch)
    assert float(m["loss"]) == float(m0["loss"])
    assert np.isfinite(float(m["loss"]))
    for a, b in zip(ts.param_leaves(state.params)["stage1"],
                    ts.param_leaves(plain.params)["stage1"]):
        assert torch.equal(a, b)


def test_ensure_optimizer_state_is_adamws_first_state():
    """The optimizer state made up front (so that every rank can take rank
    0's by broadcast) gives the first AdamW step torch's own lazy state
    gives."""
    _, tc = training_configs()
    params = perturbed_params(*training_configs())[1]
    a = ts.init_train_state(params, "cpu")
    b = ts.init_train_state(params, "cpu")
    ts.ensure_optimizer_state(b.opt)
    grads = {k: [torch.full_like(p, 0.1) for p in ps]
             for k, ps in ts.param_leaves(a.params).items()}
    ts.apply_gradients(a.opt, a.params, grads)
    ts.apply_gradients(b.opt, b.params, grads)
    for k in a.params:
        for p, q in zip(ts.param_leaves(a.params)[k],
                        ts.param_leaves(b.params)[k]):
            assert torch.equal(p, q), k
