"""Multi-client TCP serving front-end over the batched device step
(PyTorch port of ``runtime/socket_server.py``).

N concurrent callers connect over TCP, each streams raw float32 mono PCM
at ``cfg.dsp.in_rate`` and reads converted PCM back at
``cfg.dsp.out_rate`` (the resample edges of the step); ALL active streams
advance together in ONE :class:`BatchedServer` step per tick.

Wire protocol (deliberately trivial — any client that can open a socket
and write floats can use it):
  client -> server   raw little-endian float32 PCM, any write sizes
  client EOF (shutdown(SHUT_WR)) -> server drains algorithmic latency,
  sends the tail, closes.
  server -> client   raw little-endian float32 converted PCM

Threading topology:
  * per connection: a reader thread (socket -> native input ring) and a
    writer thread (native output ring -> socket) — each ring has exactly
    one producer and one consumer, race-free by construction
  * one ticker thread owns the device: it pops a chunk per active slot
    (silence on underrun, counted — the reference's realtime contract),
    replays the batched step's captured program (``BatchedServer``) on
    the CUDA stream that was current when the server was made, and pushes
    per-slot outputs.  Accept and client threads touch only ring
    buffers.
  * slots are fixed (this rank's ``BatchedServer.local_slots``); a new
    connection claims a free slot and schedules its carry reset on the
    next tick's in-step reset mask (drop/rejoin); a full server refuses
    with an immediate close.

Several ranks (``parallel/multihost.py``): every rank runs this same
server on its own port, accepts its own clients into its local slot range
and feeds them through ``step_local``; the ranks' lanes are independent
and each ticker runs at its own pace.  With a model split (``mesh`` with
model_parallel > 1) the step is collective over the model group, whose
ranks hold the same slots and must feed the same rows: the group's first
rank alone takes clients, and its ticker sends each tick's chunks and
live / reset masks to the others (one broadcast over the group), which
step with them.  It ticks every period even with every lane idle, so the
others never wait long in the broadcast, and resets ride the in-step
mask.  Shut such ranks down together: closing the first rank releases the
others; a rank that stops otherwise holds its partners in the collective
until the group's timeout.

``realtime_factor`` throttles the ticker (1.0 = wall-clock realtime,
0 = free-running for offline/batch use).
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
from realtime_yukarin_tpu_torch.runtime import RingBuffer
from realtime_yukarin_tpu_torch.utils import profiling
from realtime_yukarin_tpu_torch.utils.metrics import ServingMetrics


def take_chunk(slot: "_Slot", S: int, realtime: bool
               ) -> tuple[np.ndarray | None, bool]:
    """This tick's S input samples for an active slot (None to pause it),
    and whether they are an underrun's silence.

    S samples when its ring holds them.  After the client's EOF, at most S
    of what is left, padded with silence (``drain_left`` counts down on
    the all-silence chunks that drain the algorithmic latency).  The ring
    is read once for the choice and again for the pop, and the reader may
    push its last data and set ``eof`` in between, so the drain pops at
    most S whatever the ring holds by then.  In realtime mode an underrun
    is fed silence; free-running, the slot pauses."""
    if slot.in_rb.available >= S:
        return slot.in_rb.pop(S), False
    if slot.eof:
        tail = slot.in_rb.pop(min(slot.in_rb.available, S))
        if len(tail) == 0:
            slot.drain_left -= 1
        chunk = np.zeros(S, np.float32)
        chunk[:len(tail)] = tail
        return chunk, False
    return (np.zeros(S, np.float32) if realtime else None), realtime


class _Slot:
    def __init__(self, capacity: int):
        self.in_rb = RingBuffer(capacity)
        self.out_rb = RingBuffer(capacity)
        self.active = False          # owned by server lock
        self.eof = False             # reader saw client EOF
        self.drain_left = 0          # silence chunks still owed after EOF
        self.done = threading.Event()  # tail fully pushed to out ring
        self.gen = 0                 # claim generation: a stale reader from
        #                              a previous connection must never push
        #                              into a reclaimed slot's ring
        self.pending_reset = False   # carry reset owed on the next tick
        #                              (rides the in-step reset mask, so
        #                              the ticker alone touches the device)
        self.reader: threading.Thread | None = None


class SocketVoiceServer:
    """Serve ``num_streams`` concurrent conversion streams over TCP, on
    ``device`` (``cuda`` unless the caller passes another; no fallback).
    ``mesh`` is the BatchedServer's layout (default: data-parallel over the
    process group).  A rank that follows its model group's first rank
    takes no clients: its ``address`` is None."""

    def __init__(self, params: dict, cfg: Config, host: str = "127.0.0.1",
                 port: int = 0, num_streams: int = 8,
                 realtime_factor: float = 0.0, use_sr: bool = True,
                 ring_seconds: float = 8.0, seed: int = 0,
                 sock_sndbuf: int | None = None, vocoder_mode: str = "dsp",
                 device=None, mesh=None):
        self._cfg = cfg
        self._sndbuf = sock_sndbuf    # bound kernel memory per client; small
        #                               values surface ring backpressure fast
        self._server = BatchedServer(params, cfg, num_streams=num_streams,
                                     use_sr=use_sr, seed=seed,
                                     vocoder_mode=vocoder_mode,
                                     device=device, mesh=mesh)
        self.device = self._server.device
        self.program = self._server.program
        self._S = self._server.chunk_samples            # input chunk
        self._So = self._server.chunk_out_samples       # output chunk
        self._n_drain = -(-self._server.latency_samples // self._So) + 1
        self._rt = realtime_factor
        cap = int(ring_seconds * max(cfg.dsp.in_rate, cfg.dsp.out_rate))
        self._slots = [_Slot(cap)
                       for _ in range(len(self._server.local_slots))]
        # a model split makes every step collective over the model group,
        # whose first rank (global rank _lead) feeds the rows of all
        mesh = self._server.mesh
        self._group = mesh.model_group if mesh.model_parallel > 1 else None
        self._lead = mesh.rank - mesh.model_index
        self._lock = threading.Lock()
        self.metrics = ServingMetrics()
        # the ticker runs the step on the stream current here
        self._cuda_stream = (torch.cuda.current_stream(self.device)
                             if self.device.type == "cuda" else None)

        # the BatchedServer captured its step above, before any thread of
        # this server starts; one step before accepting traffic (a claimed
        # slot's lane is reset before its first chunk)
        self._server.step_local(np.zeros((len(self._slots), self._S),
                                         np.float32))

        self._stop = threading.Event()
        self._clients = []           # (connection, its reader and writer)
        self._sock, self.address = None, None
        if mesh.rank != self._lead:
            self._threads = [threading.Thread(
                target=self._run_ticker, args=(self._follow_loop,),
                daemon=True, name="vc-follower")]
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(num_streams)
            self.address = self._sock.getsockname()
            self._threads = [
                threading.Thread(target=self._accept_loop, daemon=True,
                                 name="vc-accept"),
                threading.Thread(target=self._run_ticker,
                                 args=(self._tick_loop_impl,), daemon=True,
                                 name="vc-ticker"),
            ]
        for t in self._threads:
            t.start()

    @property
    def chunk_samples(self) -> int:
        """Input chunk size (samples at cfg.dsp.in_rate)."""
        return self._S

    @property
    def chunk_out_samples(self) -> int:
        return self._So

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                # wakes the accept thread (closing alone does not on Linux)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=30.0)
        # no thread of the server outlives close(): wake and join each
        # connection's reader (in recv) and writer (in sendall)
        for conn, *threads in self._clients:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            for t in threads:
                t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- accept / per-connection threads -------------------------------------

    def _claim_slot(self) -> int | None:
        with self._lock:
            for i, s in enumerate(self._slots):
                if not s.active:
                    s.gen += 1                        # fence stale producers
                    if s.reader is not None and s.reader.is_alive():
                        # the previous connection's reader must be gone
                        # before the ring gets a new producer (SPSC)
                        s.reader.join(timeout=5.0)
                        if s.reader.is_alive():
                            s.gen -= 1
                            continue                  # try another slot
                    s.in_rb.pop(s.in_rb.available)   # clear stale data
                    s.out_rb.pop(s.out_rb.available)
                    s.eof = False
                    s.drain_left = self._n_drain
                    s.done.clear()
                    # the carry reset rides the next tick's in-step reset
                    # mask (applied before that tick's chunk): only the
                    # ticker thread touches the device
                    s.pending_reset = True
                    s.active = True
                    return i
        return None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                      # socket closed
            if self._sndbuf:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self._sndbuf)
            i = self._claim_slot()
            if i is None:
                self.metrics.incr("rejected_connections")
                conn.close()
                continue
            self.metrics.incr("accepted_connections")
            reader = threading.Thread(target=self._conn_reader,
                                      args=(conn, i), daemon=True,
                                      name=f"vc-read-{i}")
            writer = threading.Thread(target=self._conn_writer,
                                      args=(conn, i), daemon=True,
                                      name=f"vc-write-{i}")
            self._slots[i].reader = reader
            self._clients = [c for c in self._clients if c[2].is_alive()]
            self._clients.append((conn, reader, writer))
            reader.start()
            writer.start()

    def _conn_reader(self, conn: socket.socket, i: int) -> None:
        slot = self._slots[i]
        my_gen = slot.gen
        carry = b""
        try:
            while not self._stop.is_set() and slot.gen == my_gen:
                data = conn.recv(65536)
                if not data:
                    break
                data = carry + data
                n4 = len(data) // 4 * 4
                carry = data[n4:]
                pcm = np.frombuffer(data[:n4], "<f4")
                while (len(pcm) and not self._stop.is_set()
                       and slot.gen == my_gen):
                    pushed = slot.in_rb.push(pcm)
                    if pushed < len(pcm):
                        self.metrics.incr("input_overruns")
                        time.sleep(0.005)   # ring full: backpressure
                    pcm = pcm[pushed:]
        except OSError:
            pass
        if slot.gen == my_gen:
            slot.eof = True

    def _conn_writer(self, conn: socket.socket, i: int) -> None:
        slot = self._slots[i]
        try:
            while not self._stop.is_set():
                out = slot.out_rb.pop(slot.out_rb.available)
                if len(out):
                    conn.sendall(out.astype("<f4").tobytes())
                elif slot.done.is_set():
                    break
                else:
                    time.sleep(0.002)
        except OSError:
            pass
        finally:
            try:
                # shutdown first: it wakes this connection's reader in recv
                # (a close from this thread would not)
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                slot.active = False

    # -- device ticker --------------------------------------------------------

    def _run_ticker(self, loop) -> None:
        try:
            with torch.no_grad():
                if self._cuda_stream is not None:
                    with torch.cuda.stream(self._cuda_stream):
                        loop()
                else:
                    loop()
        except Exception as e:                         # noqa: BLE001
            # a dead ticker must not leave clients hanging silently:
            # stop accepting, release every stream, surface the error
            import traceback
            self.metrics.incr("ticker_errors")
            print(f"[socket_server] ticker died: {e!r}\n"
                  f"{traceback.format_exc()}", flush=True)
            self._stop.set()
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
            for s in self._slots:
                s.done.set()

    def _exchange(self, chunks=None, live=None, reset=None,
                  stop: bool = False):
        """The model group's rows for this tick: the first rank sends its
        chunks, masks and whether it stops (one broadcast), every other
        rank receives them.  Returns device tensors (chunks, live, reset)
        and the stop flag."""
        n, S = len(self._slots), self._S
        if chunks is None:
            buf = torch.empty(n * S + 2 * n + 1, device=self.device)
        else:
            buf = torch.from_numpy(np.concatenate(
                [chunks.reshape(-1), live, reset, [stop]]
            ).astype(np.float32)).to(self.device)
        dist.broadcast(buf, src=self._lead, group=self._group)
        return (buf[: n * S].view(n, S), buf[n * S: n * S + n] > 0,
                buf[n * S + n: n * S + 2 * n] > 0, bool(buf[-1] > 0))

    def _step(self, chunks, live, reset) -> np.ndarray:
        if self._group is None:
            return self._server.step_local(chunks, live=live, reset=reset)
        c, lv, rs, _ = self._exchange(chunks, live, reset)
        return self._server.step_device(c, lv, rs).cpu().numpy()

    def _follow_loop(self) -> None:
        """A following rank of a model group: step with the first rank's
        rows until it stops."""
        while True:
            c, lv, rs, stop = self._exchange()
            if stop:
                return
            self._server.step_device(c, lv, rs)

    def _push(self, out: np.ndarray, live: np.ndarray, gens: list) -> None:
        """Each live lane's output into its slot's ring."""
        for i in np.flatnonzero(live):
            s = self._slots[i]
            with self._lock:
                # drop the output if the slot was reclaimed mid-step
                # (never leak one client's audio into the next)
                if not s.active or s.gen != gens[i]:
                    continue
                pushed = s.out_rb.push(out[i])
            if pushed < self._So:
                self.metrics.incr("output_overruns")
            if s.eof and s.drain_left <= 0:
                s.done.set()

    def _tick_loop_impl(self) -> None:
        """One tick: scan the slots for chunks and masks (span
        ``host.tick.scan``), step (``host.tick.step``), push each live
        lane's output to its ring (``host.tick.push``).  Each tick that
        steps counts its paused lanes (a caller's lane not live:
        ``lane_ticks_paused``) and its resets (``lane_resets``)."""
        S = self._S
        period = (S / self._cfg.dsp.in_rate / self._rt
                  if self._rt > 0 else 0.0)
        N = len(self._slots)
        chunks = np.zeros((N, S), np.float32)
        live = np.zeros((N,), bool)
        reset = np.zeros((N,), bool)
        held = np.zeros((N,), bool)       # a caller holds the lane
        while not self._stop.is_set():
            t0 = time.perf_counter()
            live[:] = False
            reset[:] = False
            held[:] = False
            gens = [0] * N
            # claim/free cannot interleave the scan
            with profiling.span("host.tick.scan"), self._lock:
                for i, s in enumerate(self._slots):
                    if s.pending_reset:
                        # applied before this tick's chunk (in-step mask);
                        # valid even while the lane stays paused
                        reset[i] = True
                        s.pending_reset = False
                    if not s.active or s.done.is_set():
                        chunks[i] = 0.0
                        continue
                    held[i] = True
                    if not period and s.out_rb.free_space < self._So:
                        # free-running backpressure: a slow reader
                        # pauses ITS slot (carry untouched, input queues
                        # in its ring, which backpressures the producer)
                        # instead of losing converted audio.  Realtime
                        # mode keeps the drop-and-count contract —
                        # stalling would break the clock.
                        self.metrics.incr("output_backpressure_ticks")
                        chunks[i] = 0.0
                        continue
                    gens[i] = s.gen
                    chunk, underrun = take_chunk(s, S, bool(period))
                    if chunk is None:
                        # free-running mode: a not-ready slot is PAUSED
                        # via the live mask, its device carry untouched
                        chunks[i] = 0.0
                        continue
                    if underrun:
                        # realtime contract: a slow producer gets silence
                        # fed through its stream so its clock advances
                        self.metrics.incr("tick_underruns")
                    chunks[i] = chunk
                    live[i] = True
            if not (live.any() or reset.any()):
                time.sleep(0.002)
                if self._group is None:
                    continue
                # the model group's other ranks wait in the broadcast:
                # tick anyway (the sleep bounds the spin)
            self.metrics.incr("lane_ticks_paused",
                              int(np.count_nonzero(held & ~live)))
            self.metrics.incr("lane_resets", int(np.count_nonzero(reset)))
            t_lat = time.perf_counter()
            with profiling.span("host.tick.step"):
                out = self._step(chunks, live, reset)
            self.metrics.chunk_latency.record(
                1000.0 * (time.perf_counter() - t_lat))
            with profiling.span("host.tick.push"):
                self._push(out, live, gens)
            if period:
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)
        if self._group is not None:
            self._exchange(chunks, live, reset, stop=True)   # release them


def convert_over_socket(host: str, port: int, pcm: np.ndarray,
                        chunk_bytes: int = 32768) -> np.ndarray:
    """Blocking client helper: stream ``pcm`` to the server, return the
    converted waveform (reads until server closes)."""
    data = np.ascontiguousarray(pcm, np.float32).astype("<f4").tobytes()
    out = bytearray()
    with socket.create_connection((host, port)) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def pump():
            for off in range(0, len(data), chunk_bytes):
                s.sendall(data[off: off + chunk_bytes])
            s.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        while True:
            b = s.recv(65536)
            if not b:
                break
            out.extend(b)
        t.join()
    return np.frombuffer(bytes(out), "<f4")
