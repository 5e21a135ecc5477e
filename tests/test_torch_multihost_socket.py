"""Multi-process socket serving with the port (the counterpart of
tests/test_multihost_socket.py), and the ticker's drain choice.

Two gloo ranks on the CPU each front their local half of an 8-slot server
with their own ``SocketVoiceServer`` (own port, own accept loop); one TCP
client per rank streams its own signal.  What each client gets back is
bit-equal to the same worker at one rank serving the same signal on the
same global slot (lane keys are global, so the rank-1 client's slot 4 is
reached at one rank by parking four idle connections first).  With the
weights split over the two ranks, the first rank alone takes clients and
feeds the second its rows.  Tiny model config, float32, seeded perturbed
weights."""

import json
import time

import numpy as np
import pytest

import torch_multihost as tm
from realtime_yukarin_tpu_torch.runtime.socket_server import take_chunk
from torch_parity import configs, perturbed_params

N = 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost_socket")
    jc, tc = configs()
    np.savez(d / "params.npz", **perturbed_params(jc, tc)[2])
    (d / "config.json").write_text(json.dumps(tc.to_dict()))
    tm.wait_ranks(
        tm.start_ranks(d, "socket", 2, n=N, tag="two"),
        tm.start_ranks(d, "socket", 1, n=N, tag="one"),
        tm.start_ranks(d, "socket", 2, n=N, model_parallel=2, tag="mp"))
    return d


def test_two_rank_socket_serving_bit_equals_one_rank(runs):
    ref = tm.load(runs, "socket", "one", 0)
    for rank in range(2):
        got = tm.load(runs, "socket", "two", rank)
        assert int(got["lo"]) == rank * N // 2
        assert len(got["out"]) and np.isfinite(got["out"]).all()
        np.testing.assert_array_equal(got["out"], ref[f"out{rank}"])
    # the two streams differ (other signals, other lane keys)
    n = min(len(ref["out0"]), len(ref["out1"]))
    assert not np.array_equal(ref["out0"][:n], ref["out1"][:n])


def test_model_split_socket_serves_the_first_ranks_clients(runs):
    """With the weights split over both ranks (one model group), rank 0
    takes the clients and sends each tick's rows to rank 1, which takes
    none; rank 0's client (slot 0) gets what one unsplit process gives it,
    to 1e-6 of the peak (tests/test_torch_multihost_serving.py: a
    half-width weight sums in another order)."""
    ref = tm.load(runs, "socket", "one", 0)["out0"]
    lead, follower = (tm.load(runs, "socket", "mp", r) for r in range(2))
    assert "out" not in follower and int(follower["lo"]) == 0
    got = lead["out"]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


def test_close_leaves_no_server_thread():
    """After close() no thread of the server runs on: not the reader of a
    connection whose client sends nothing and never closes, not a
    writer (a daemon thread left in the ring buffer's native code at
    interpreter exit aborted a process now and then)."""
    import socket
    import threading

    from realtime_yukarin_tpu_torch.runtime.socket_server import (
        SocketVoiceServer, convert_over_socket)
    jc, tc = configs()
    srv = SocketVoiceServer(perturbed_params(jc, tc)[1], tc, num_streams=2,
                            device="cpu")
    try:
        y = convert_over_socket(*srv.address, tm.socket_signal(0, 24000))
        idle = socket.create_connection(srv.address)
        deadline = time.time() + 30
        while srv.metrics.counters.get("accepted_connections", 0) < 2:
            assert time.time() < deadline
            time.sleep(0.01)
    finally:
        srv.close()
    assert len(y) > 0
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("vc-")]
    idle.close()
    assert not left, left


def test_serve_cli_two_ranks_under_the_launch_environment(tmp_path):
    """``cli.serve --socket PORT`` launched as two ranks through the JAX
    package's environment names: each rank reports itself and its half of
    the slots, and rank 1 serves a client on PORT + 1."""
    from realtime_yukarin_tpu_torch.runtime.socket_server import (
        convert_over_socket)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(configs()[1].to_dict()))
    port = tm.free_port()
    procs = tm.start_cli("realtime_yukarin_tpu_torch.cli.serve", [
        "--socket", str(port), "--host", "127.0.0.1", "--num_streams", "4",
        "--duration", "10", "--config_path", str(cfg), "--device", "cpu"],
        2, via_env=True)
    x = tm.socket_signal(1, 24000)
    deadline = time.time() + 60
    try:
        while True:
            try:
                y = convert_over_socket("127.0.0.1", port + 1, x)
                break
            except OSError:
                assert time.time() < deadline, "rank 1 never served"
                time.sleep(0.2)
    finally:
        outs = tm.wait_ranks(procs)[0]
    for rank, out in enumerate(outs):
        assert f"2 local stream slots on cpu (host {rank}/2)" in out, out
    assert len(y) > 0 and np.isfinite(y).all()


class _Ring:
    """A ring whose ``available`` reads come from a script: the reader
    thread pushes between the ticker's two reads."""

    def __init__(self, reads, held: int):
        self._reads = list(reads)
        self.held = held
        self.popped = []

    @property
    def available(self) -> int:
        return self._reads.pop(0) if self._reads else self.held

    def pop(self, n: int) -> np.ndarray:
        n = min(n, self.held)
        self.held -= n
        self.popped.append(n)
        return np.ones(n, np.float32)


class _Slot:
    def __init__(self, ring, eof: bool):
        self.in_rb, self.eof, self.drain_left = ring, eof, 3


S = 120


@pytest.mark.parametrize("first_read,held,popped,drain_left", [
    # the race: the ticker saw fewer than S, then the reader pushed its
    # last data and set eof; the drain pops exactly S, owes no drain chunk
    (S - 20, 2 * S + 5, S, 3),
    (S - 20, S - 20, S - 20, 3),     # a short tail, padded with silence
    (0, 0, 0, 2),                    # drained: a silence chunk is counted
])
def test_drain_pops_at_most_one_chunk(first_read, held, popped, drain_left):
    ring = _Ring([first_read], held)
    slot = _Slot(ring, eof=True)
    chunk, underrun = take_chunk(slot, S, realtime=False)
    assert chunk.shape == (S,) and not underrun
    assert ring.popped == [popped] and int(chunk.sum()) == popped
    assert slot.drain_left == drain_left


def test_take_chunk_pauses_or_fills_an_underrun():
    """Before EOF a short ring pauses the slot free-running and feeds an
    underrun's silence in realtime mode; a full ring gives S samples."""
    assert take_chunk(_Slot(_Ring([], 10), eof=False), S, False) == (None,
                                                                      False)
    chunk, underrun = take_chunk(_Slot(_Ring([], 10), eof=False), S, True)
    assert underrun and chunk.shape == (S,) and not chunk.any()
    ring = _Ring([], 3 * S)
    chunk, underrun = take_chunk(_Slot(ring, eof=False), S, False)
    assert ring.popped == [S] and not underrun
