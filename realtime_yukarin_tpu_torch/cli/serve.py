"""Realtime streaming conversion CLI of the PyTorch port (port of
``cli/serve.py``) — the ``upstream:run.py`` equivalent.

Raw float32 PCM flows in on stdin (or from a wav file) and out on stdout
(or to a wav file); the step in between is the port's streaming step on
the device.  Four modes: the synchronous stream (default),
``--pipelined`` (dispatch-ahead, native ring buffers), ``--live`` (mic ->
speaker through sounddevice or PyAudio) and ``--socket PORT`` (N
concurrent TCP clients, one batched device step per tick).  Runs on
``cuda`` unless ``--device`` names another device (no fallback).
Parameters are read in the JAX package's ``.npz`` or ``.msgpack`` layout.

Per-chunk wall-clock metrics (p50/p99) are printed to stderr at exit.

Usage:
    # simulated realtime from a wav file:
    python -m realtime_yukarin_tpu_torch.cli.serve --input_wav in.wav \
        --output_wav out.wav [--realtime_factor 1.0] [--device cpu]
    # raw PCM pipe mode (float32 mono @ sample_rate):
    arecord ... | python -m realtime_yukarin_tpu_torch.cli.serve | aplay ...
    # 64 concurrent TCP streams:
    python -m realtime_yukarin_tpu_torch.cli.serve --socket 9999 \
        --num_streams 64

Several ranks (one process per GPU): set ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` for every process, as for the
JAX package.  With ``--socket PORT`` rank r then serves its share of the
``--num_streams`` slots (rounded up to the ranks) on port PORT + r.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from realtime_yukarin_tpu_torch.config import VOCODER_MODES, Config
from realtime_yukarin_tpu_torch.models.vocoders import mode_from_flags
from realtime_yukarin_tpu_torch.models.voice_changer import (init_params,
                                                             load_all_params)
from realtime_yukarin_tpu_torch.parallel.multihost import (init_multihost,
                                                           rank_device)
from realtime_yukarin_tpu_torch.streaming.pipeline import resolve_device
from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream
from realtime_yukarin_tpu_torch.utils.audio_io import (read_raw_f32,
                                                       read_wav,
                                                       write_raw_f32,
                                                       write_wav)


def _metrics_report(lat_ms: list[float]) -> str:
    if not lat_ms:
        return "no chunks processed"
    a = np.asarray(lat_ms)
    return (f"chunks={len(a)} p50={np.percentile(a, 50):.2f}ms "
            f"p99={np.percentile(a, 99):.2f}ms max={a.max():.2f}ms")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config_path", default=None)
    p.add_argument("--params_path", default=None)
    p.add_argument("--input_wav", default=None,
                   help="simulated-realtime mode: read from wav")
    p.add_argument("--output_wav", default=None)
    p.add_argument("--realtime_factor", type=float, default=0.0,
                   help=">0: sleep to simulate a live mic at this speed")
    p.add_argument("--neural_vocoder", action="store_true",
                   help="legacy spelling of --vocoder ddsp")
    p.add_argument("--vocoder", choices=list(VOCODER_MODES),
                   default=None, help="synthesis stage (default: config)")
    p.add_argument("--no_sr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pipelined", action="store_true",
                   help="dispatch-ahead pipelined server (native ring "
                        "buffers, device double-buffering)")
    p.add_argument("--depth", type=int, default=2,
                   help="in-flight device chunks in --pipelined mode")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler (Chrome) trace of the "
                        "serving loop here")
    p.add_argument("--live", action="store_true",
                   help="mic -> speaker mode via sounddevice/PyAudio (the "
                        "reference run.py loop); requires an audio backend")
    p.add_argument("--audio_backend", default="auto",
                   choices=["auto", "sounddevice", "pyaudio"])
    p.add_argument("--input_device", default=None,
                   help="--live capture device (name substring or index; "
                        "default from config, else system default)")
    p.add_argument("--output_device", default=None,
                   help="--live playback device")
    p.add_argument("--list_devices", action="store_true",
                   help="print the audio device table and exit")
    p.add_argument("--duration", type=float, default=None,
                   help="--live / --socket: stop after this many seconds "
                        "(default: run until Ctrl-C)")
    p.add_argument("--socket", type=int, default=None, metavar="PORT",
                   help="multi-client TCP server mode: N concurrent raw-f32 "
                        "PCM streams, one batched device step per tick")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--num_streams", type=int, default=8,
                   help="slots in --socket mode")
    p.add_argument("--realtime_factor_serve", type=float, default=0.0,
                   help="throttle the --socket ticker (0 = free-running)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: this rank's card; "
                        "no fallback)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of a multi-process run "
                        "(default: nccl on cuda, gloo on cpu; gloo for "
                        "ranks sharing a card)")
    args = p.parse_args(argv)

    if args.list_devices:
        from realtime_yukarin_tpu_torch.runtime.live_audio import (
            format_device_table, load_backend)
        print(format_device_table(load_backend(args.audio_backend)
                                  .list_devices()))
        return

    device = resolve_device(args.device)
    # a multi-process launch (the JAX package's environment names; a no-op
    # without them): --socket then serves this rank's slot range
    rank, world = init_multihost(backend=args.backend, device=device)
    device = rank_device(device)
    cfg = Config.from_yaml(args.config_path) if args.config_path else Config()
    args.vocoder_mode = mode_from_flags(args.vocoder, args.neural_vocoder,
                                        cfg)
    params = init_params(cfg, torch.Generator().manual_seed(cfg.seed),
                         device, vocoder_mode=args.vocoder_mode)
    params = load_all_params(params, cfg, params_path=args.params_path)

    from realtime_yukarin_tpu_torch.utils.profiling import trace
    if args.socket is not None:
        from realtime_yukarin_tpu_torch.runtime.socket_server import \
            SocketVoiceServer
        port = args.socket + rank if args.socket else 0
        with trace(args.profile_dir), SocketVoiceServer(
                params, cfg, host=args.host, port=port,
                num_streams=args.num_streams,
                realtime_factor=args.realtime_factor_serve,
                use_sr=not args.no_sr,
                vocoder_mode=args.vocoder_mode,
                seed=args.seed, device=device) as srv:
            print(f"[serve] socket server on {srv.address}, "
                  f"{len(srv._slots)} local stream slots on {device} "
                  f"(host {rank}/{world})", file=sys.stderr)
            print(f"[serve] {srv.program.summary()}", file=sys.stderr)
            t_end = (None if args.duration is None
                     else time.monotonic() + args.duration)
            try:
                while t_end is None or time.monotonic() < t_end:
                    left = 10.0 if t_end is None else t_end - time.monotonic()
                    time.sleep(max(0.0, min(10.0, left)))
                    print(f"[serve] {srv.metrics.to_json()}",
                          file=sys.stderr)
            except KeyboardInterrupt:
                pass
        return

    if args.live:
        from realtime_yukarin_tpu_torch.runtime import live_audio
        from realtime_yukarin_tpu_torch.runtime.pipelined import \
            PipelinedStream
        backend = live_audio.load_backend(args.audio_backend)
        with trace(args.profile_dir), PipelinedStream(
                params, cfg, use_sr=not args.no_sr,
                vocoder_mode=args.vocoder_mode, seed=args.seed,
                depth=args.depth, device=device) as stream:
            session = live_audio.LiveSession(
                stream, cfg, backend,
                input_device=args.input_device or cfg.input_device,
                output_device=args.output_device or cfg.output_device)
            print(f"[serve] live: mic @{cfg.dsp.in_rate} Hz -> speaker "
                  f"@{cfg.dsp.out_rate} Hz, algorithmic latency="
                  f"{stream.latency_samples} samples; Ctrl-C to stop",
                  file=sys.stderr)
            print(f"[serve] {stream.program.summary()}", file=sys.stderr)
            session.run(duration=args.duration)
            print(f"[serve] {stream.metrics.to_json()}", file=sys.stderr)
        return

    if args.pipelined:
        with trace(args.profile_dir):
            _serve_pipelined(args, cfg, params)
        return

    stream = VoiceChangerStream(params, cfg, use_sr=not args.no_sr,
                                vocoder_mode=args.vocoder_mode,
                                seed=args.seed, device=device)
    S = stream.chunk_samples
    fs = cfg.dsp.in_rate
    fs_out = cfg.dsp.out_rate
    lat_ms: list[float] = []
    outputs: list[np.ndarray] = []

    print(f"[serve] chunk={S} samples ({1000 * S / fs:.0f} ms) @{fs} Hz in, "
          f"@{fs_out} Hz out, algorithmic latency="
          f"{stream.latency_samples} samples "
          f"({1000 * stream.latency_samples / fs_out:.0f} ms)",
          file=sys.stderr)
    print(f"[serve] {stream.program.summary()}", file=sys.stderr)

    def push(chunk: np.ndarray) -> None:
        t0 = time.perf_counter()
        stream.add(chunk)
        y = stream.process()
        lat_ms.append(1000 * (time.perf_counter() - t0))
        if args.output_wav:
            outputs.append(y)
        else:
            write_raw_f32(sys.stdout.buffer, y)

    with trace(args.profile_dir):
        if args.input_wav:
            x, _ = read_wav(args.input_wav, target_rate=fs)
            n_chunks = len(x) // S
            for k in range(n_chunks):
                if args.realtime_factor > 0:
                    time.sleep(S / fs / args.realtime_factor)
                push(x[k * S: (k + 1) * S])
        else:
            while True:
                chunk = read_raw_f32(sys.stdin.buffer, S)
                if chunk is None:
                    break
                push(chunk)

    tail = stream.flush()
    if args.output_wav:
        outputs.append(tail)
        write_wav(args.output_wav, np.concatenate(outputs), fs_out)
    else:
        write_raw_f32(sys.stdout.buffer, tail)

    print(f"[serve] {_metrics_report(lat_ms)}", file=sys.stderr)


def _serve_pipelined(args, cfg: Config, params: dict) -> None:
    """Dispatch-ahead mode: audio edges on native ring buffers, up to
    --depth chunks in flight on the device (runtime/pipelined.py)."""
    from realtime_yukarin_tpu_torch.runtime.pipelined import PipelinedStream

    with PipelinedStream(params, cfg, use_sr=not args.no_sr,
                         vocoder_mode=args.vocoder_mode,
                         seed=args.seed, depth=args.depth,
                         device=args.device) as stream:
        S = stream.chunk_samples
        fs = cfg.dsp.in_rate
        print(f"[serve] pipelined depth={args.depth} chunk={S} samples "
              f"({1000 * S / fs:.0f} ms), algorithmic latency="
              f"{stream.latency_samples} samples", file=sys.stderr)
        print(f"[serve] {stream.program.summary()}", file=sys.stderr)
        outputs: list[np.ndarray] = []

        def drain(n: int | None = None) -> None:
            avail = stream.output_available() if n is None else n
            if avail <= 0:
                return
            y = stream.pop_output(avail)
            if args.output_wav:
                outputs.append(y)
            else:
                write_raw_f32(sys.stdout.buffer, y)

        if args.input_wav:
            x, _ = read_wav(args.input_wav, target_rate=fs)
            for k in range(len(x) // S):
                if args.realtime_factor > 0:
                    time.sleep(S / fs / args.realtime_factor)
                stream.push_input(x[k * S: (k + 1) * S])
                drain()
        else:
            while True:
                chunk = read_raw_f32(sys.stdin.buffer, S)
                if chunk is None:
                    break
                stream.push_input(chunk)
                drain()
        stream.flush()
        drain()
        if args.output_wav:
            y = (np.concatenate(outputs) if outputs
                 else np.zeros(0, np.float32))
            write_wav(args.output_wav, y, cfg.dsp.out_rate)
        print(f"[serve] {stream.metrics.to_json()}", file=sys.stderr)


if __name__ == "__main__":
    main()
