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
    runs the batched step on the CUDA stream that was current when the
    server was made, and pushes per-slot outputs.  Accept and client
    threads touch only ring buffers.
  * slots are fixed; a new connection claims a free slot and schedules
    its carry reset on the next tick's in-step reset mask (drop/rejoin);
    a full server refuses with an immediate close.

One process on one GPU: the JAX package's multi-host path (every host
ticking one global program in lockstep) is not ported yet.

``realtime_factor`` throttles the ticker (1.0 = wall-clock realtime,
0 = free-running for offline/batch use).
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import Config
from realtime_yukarin_tpu_torch.parallel.serving import BatchedServer
from realtime_yukarin_tpu_torch.runtime import RingBuffer
from realtime_yukarin_tpu_torch.utils.metrics import ServingMetrics


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
    ``device`` (``cuda`` unless the caller passes another; no fallback)."""

    def __init__(self, params: dict, cfg: Config, host: str = "127.0.0.1",
                 port: int = 0, num_streams: int = 8,
                 realtime_factor: float = 0.0, use_sr: bool = True,
                 use_neural_vocoder: bool = False, ring_seconds: float = 8.0,
                 seed: int = 0, sock_sndbuf: int | None = None,
                 vocoder_mode: str | None = None, device=None):
        self._cfg = cfg
        self._sndbuf = sock_sndbuf    # bound kernel memory per client; small
        #                               values surface ring backpressure fast
        self._server = BatchedServer(params, cfg, num_streams=num_streams,
                                     use_sr=use_sr,
                                     use_neural_vocoder=use_neural_vocoder,
                                     seed=seed, vocoder_mode=vocoder_mode,
                                     device=device)
        self.device = self._server.device
        self._S = self._server.chunk_samples            # input chunk
        self._So = self._server.chunk_out_samples       # output chunk
        self._n_drain = -(-self._server.latency_samples // self._So) + 1
        self._rt = realtime_factor
        cap = int(ring_seconds * max(cfg.dsp.in_rate, cfg.dsp.out_rate))
        self._slots = [_Slot(cap) for _ in range(self._server.num_streams)]
        self._lock = threading.Lock()
        self.metrics = ServingMetrics()
        # the ticker runs the step on the stream current here
        self._cuda_stream = (torch.cuda.current_stream(self.device)
                             if self.device.type == "cuda" else None)

        # build the kernels and run one step before accepting traffic (a
        # claimed slot's lane is reset before its first chunk)
        self._server.step(np.zeros((len(self._slots), self._S), np.float32))

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(num_streams)
        self.address = self._sock.getsockname()

        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="vc-accept"),
            threading.Thread(target=self._tick_loop, daemon=True,
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
            self._slots[i].reader = reader
            reader.start()
            threading.Thread(target=self._conn_writer, args=(conn, i),
                             daemon=True, name=f"vc-write-{i}").start()

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
                conn.close()
            except OSError:
                pass
            with self._lock:
                slot.active = False

    # -- device ticker --------------------------------------------------------

    def _tick_loop(self) -> None:
        try:
            with torch.no_grad():
                if self._cuda_stream is not None:
                    with torch.cuda.stream(self._cuda_stream):
                        self._tick_loop_impl()
                else:
                    self._tick_loop_impl()
        except Exception as e:                         # noqa: BLE001
            # a dead ticker must not leave clients hanging silently:
            # stop accepting, release every stream, surface the error
            import traceback
            self.metrics.incr("ticker_errors")
            print(f"[socket_server] ticker died: {e!r}\n"
                  f"{traceback.format_exc()}", flush=True)
            self._stop.set()
            try:
                self._sock.close()
            except OSError:
                pass
            for s in self._slots:
                s.done.set()

    def _tick_loop_impl(self) -> None:
        S = self._S
        period = (S / self._cfg.dsp.in_rate / self._rt
                  if self._rt > 0 else 0.0)
        N = len(self._slots)
        chunks = np.zeros((N, S), np.float32)
        live = np.zeros((N,), bool)
        reset = np.zeros((N,), bool)
        while not self._stop.is_set():
            t0 = time.perf_counter()
            live[:] = False
            reset[:] = False
            gens = [0] * N
            with self._lock:     # claim/free cannot interleave the scan
                for i, s in enumerate(self._slots):
                    if s.pending_reset:
                        # applied before this tick's chunk (in-step mask);
                        # valid even while the lane stays paused
                        reset[i] = True
                        s.pending_reset = False
                    if not s.active or s.done.is_set():
                        chunks[i] = 0.0
                        continue
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
                    if s.in_rb.available >= S:
                        chunks[i] = s.in_rb.pop(S)
                        live[i] = True
                    elif s.eof:
                        # drain: flush remaining input padded with silence,
                        # then feed latency-draining silence chunks
                        tailpcm = s.in_rb.pop(s.in_rb.available)
                        chunks[i] = 0.0
                        chunks[i, :len(tailpcm)] = tailpcm
                        if len(tailpcm) == 0:
                            s.drain_left -= 1
                        live[i] = True
                    elif period:
                        # realtime contract: a slow producer gets silence
                        # fed through its stream (underrun counted) so its
                        # clock keeps advancing
                        chunks[i] = 0.0
                        live[i] = True
                        self.metrics.incr("tick_underruns")
                    # free-running mode: not-ready slots are PAUSED via
                    # the live mask — their device carry is untouched
            if not (live.any() or reset.any()):
                time.sleep(0.002)
                continue
            t_lat = time.perf_counter()
            out = self._server.step(chunks, live=live, reset=reset)
            self.metrics.chunk_latency.record(
                1000.0 * (time.perf_counter() - t_lat))
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
            if period:
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)


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
