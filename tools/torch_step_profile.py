#!/usr/bin/env python3
"""Where one step of the PyTorch port spends its time on the GPU.

    python3 tools/torch_step_profile.py [--steps 10]        # streaming step
    python3 tools/torch_step_profile.py --vocoder wave --client_rate 48000
    python3 tools/torch_step_profile.py --offline [--steps 3]  # offline
    python3 tools/torch_step_profile.py --train [--steps 3] # training steps

Streaming: runs ``VoiceChangerStream(device="cuda")`` (one captured graph
per step, ``streaming/program.py``) at the default Config
(full width, bf16 models, the seeded weights and signal of chip_smoke.py,
the vocoder heads perturbed as in its phases 8-10 unless the mode is dsp),
in the ``--vocoder`` mode and at the ``--client_rate`` (in and out; default
the internal 24 kHz), warms up, then traces ``--steps`` steps with
``torch.profiler``.

``--offline``: ``pipeline.offline_convert`` on chip_smoke.py's 3 s signal
(600 frames) in each vocoder mode: two calls (the first runs eagerly, the
second captures), then ``--steps`` replays traced.

``--train``: the default Config at full width in float32 with chip_smoke's
batch (8 utterances x 100 frames); for the joint and the GAN objective in
turn, the eager step body and the captured step (``StepProgram``) side by
side, each warmed up once, then ``--steps`` steps traced on one batch;
then ``make_batch`` in its two halves: the host synthesis, and the
analysis of its 16 utterances eagerly and through the analysis program
(what ``cli.train --synthetic`` does per step is the step plus both
halves).

For each window it prints the host wall time per step, the device busy
time per step (sum of GPU kernel and copy durations; one stream, so they do
not overlap; the profiler lists a replayed graph's kernels one by one),
the device idle share, the GPU launches and the host's launch and
copy calls per step, the GPU kernels by total time and the port's kernels'
time per launch, and the device ms per stage of the step, split by the
program's stage markers as the benchmark splits it (``benchmark/stages.py``).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def profile_window(label: str, fn, n: int, program=None) -> None:
    """Trace ``n`` calls of ``fn`` (``chip_smoke.profile_stats``) and print
    the window's numbers; ``program`` is the captured program ``fn``
    replays, if any, whose summary the first line carries."""
    import torch

    import chip_smoke
    st = chip_smoke.profile_stats(fn, n)
    print(f"[profile] {label}: {torch.cuda.get_device_name(0)}; {n} steps; "
          f"host wall {st['wall_ms']:.3f} ms/step"
          + (f"; {program.summary()}" if program is not None else ""))
    if st["idle"] is None:
        print(f"[profile] {label}: device time: not measured (no CUDA "
              f"events traced)")
        return
    print(f"[profile] {label}: device busy {st['busy_ms']:.3f} ms/step, "
          f"idle share {st['idle']:.3f}, "
          f"{st['gpu_launches']:.1f} GPU launches/step, "
          f"{st['host_launches']:.1f} host launch/copy calls/step")
    rows = sorted(st["by_name"].items(), key=lambda kv: -sum(kv[1]))
    for name, times in rows[:20]:
        print(f"[profile] {label}: {sum(times) / n:9.1f} us/step "
              f"{len(times) / n:6.1f} calls/step  {name[:90]}")
    for kname, (us, per_call) in st["port"].items():
        print(f"[profile] {label}: port kernel {kname}: "
              f"{float('nan') if us is None else us:.1f} us/launch, "
              f"{per_call:.1f} launches/step")
    from benchmark import stages
    for stage, us in stages.split(st["ops"]).items():
        print(f"[profile] {label}: stage {stage}: {us / n / 1e3:.3f} "
              f"ms/step")


def profile_stream(steps: int, mode: str, rate: int | None) -> None:
    import dataclasses

    import chip_smoke
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.streaming.stream import VoiceChangerStream

    cfg = Config()
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, input_rate=rate, output_rate=rate))
    params = (chip_smoke.seeded_params(cfg) if mode == "dsp"
              else chip_smoke.vocoder_params(cfg))
    stream = VoiceChangerStream(params, cfg, seed=chip_smoke.SEED,
                                vocoder_mode=mode, device="cuda")
    S = stream.chunk_samples
    x = chip_smoke.test_signal(3.0, cfg.dsp.in_rate, chip_smoke.SEED)
    chunks = iter([x[k * S: (k + 1) * S] for k in range(len(x) // S)])

    def one_step():
        stream.add(next(chunks))
        stream.process()

    for _ in range(5):                           # warm-up
        one_step()
    profile_window(f"stream {mode} @{cfg.dsp.in_rate} Hz", one_step, steps,
                   stream.program)


def profile_offline(steps: int) -> None:
    import chip_smoke
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.models.voice_changer import params_to
    from realtime_yukarin_tpu_torch.pipeline import (cached_programs,
                                                     offline_convert)
    from realtime_yukarin_tpu_torch.streaming.pipeline import (
        noise_key_from_seed)

    cfg = Config()
    params = params_to(chip_smoke.vocoder_params(cfg), "cuda")
    x = chip_smoke.test_signal(3.0, cfg.dsp.sample_rate, chip_smoke.SEED)
    F = len(x) // cfg.dsp.hop
    key = noise_key_from_seed(chip_smoke.SEED)
    for mode in chip_smoke.VOCODER_MODES:
        def call():
            offline_convert(params, x, key, cfg, F, vocoder_mode=mode,
                            device="cuda")
        call()                                   # eager
        call()                                   # warm-up and capture
        profile_window(f"offline {mode} ({F} frames)", call, steps,
                       cached_programs()[-1])


def profile_train(steps: int) -> None:
    import functools

    import torch

    import chip_smoke
    from realtime_yukarin_tpu_torch.config import Config
    from realtime_yukarin_tpu_torch.models.discriminator import (
        init_discriminator)
    from realtime_yukarin_tpu_torch.models.voice_changer import init_params
    from realtime_yukarin_tpu_torch.pipeline import offline_analyze_eager
    from realtime_yukarin_tpu_torch.training import data
    from realtime_yukarin_tpu_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    dev = torch.device("cuda")
    seconds = chip_smoke.TRAIN_FRAMES * cfg.dsp.hop / cfg.dsp.sample_rate
    params = init_params(cfg, torch.Generator().manual_seed(0))
    disc = init_discriminator(cfg.super_resolution, cfg.dsp,
                              torch.Generator().manual_seed(1))
    host = data.synth_batch(cfg, chip_smoke.TRAIN_BATCH, seconds, seed=0)
    batch = data.analyze_batch(cfg, *host, device=dev)
    for name, make_state, body, step_fn in (
            ("train joint", lambda: ts.init_train_state(params, dev),
             functools.partial(ts.joint_step_body, cfg=cfg),
             ts.make_train_step(cfg)),
            ("train gan", lambda: ts.init_gan_train_state(params, disc, dev),
             functools.partial(ts.gan_step_body, cfg=cfg),
             ts.make_gan_train_step(cfg))):
        eager_state, state = make_state(), make_state()
        body(eager_state, batch)                 # warm-up
        step_fn(state, batch)                    # warm-up and capture
        torch.cuda.synchronize()
        profile_window(f"{name} eager", lambda: body(eager_state, batch),
                       steps)
        profile_window(f"{name} captured", lambda: step_fn(state, batch),
                       steps, step_fn.program)
    profile_window("make_batch host synthesis",
                   lambda: data.synth_batch(cfg, chip_smoke.TRAIN_BATCH,
                                            seconds, seed=1), steps)
    F = host[2].shape[1]
    waves = [torch.from_numpy(w) for w in host[0] + host[1]]
    profile_window("make_batch analysis eager", lambda: [
        offline_analyze_eager(w, cfg, F, dev) for w in waves], steps)
    profile_window("make_batch analysis captured",
                   lambda: data.analyze_batch(cfg, *host, device=dev), steps)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps traced per window (10 streaming, 3 train)")
    ap.add_argument("--train", action="store_true",
                    help="profile the training steps instead of streaming")
    ap.add_argument("--offline", action="store_true",
                    help="profile offline_convert (3 s) in each mode")
    ap.add_argument("--vocoder", choices=("dsp", "ddsp", "wave"),
                    default="dsp", help="streaming vocoder mode")
    ap.add_argument("--client_rate", type=int, default=None,
                    help="streaming client rate in and out (Hz)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 2
    if args.train:
        profile_train(args.steps or 3)
    elif args.offline:
        profile_offline(args.steps or 3)
    else:
        profile_stream(args.steps or 10, args.vocoder, args.client_rate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
