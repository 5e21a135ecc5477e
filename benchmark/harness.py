"""The harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the mix names its driver
(``drivers/<driver>.py``), and each per-layer metric has its reader
(``metrics/<metric>.py``).  The harness finds all of them by those names,
so a new configuration, mix, driver or metric is a new file and a new
entry, never an edit.  A driver provides

* ``setup(ctx) -> state``: weights and inputs from the seed, the program
  built and every shape of the cell warmed up (this is ``setup_s``);
* ``window(ctx, state) -> Window``: ``ctx.seconds`` of measured work,
  with ``ctx.tracer`` profiling a few steps in mid-window when
  ``--trace 1``;
* ``check(ctx, state, window, control=False) -> {name: value}``: after
  the window, the program's state freed, the plain reference
  (``reference/``) over the same inputs, and the numbers held against
  ``checks/<workload>.json``'s limits.  ``control=True`` also reads the
  control (the reference one precision lower) in the program's place.

The run prints one JSON line last on standard output; it prints none, and
exits non-zero, without a card, with fewer cards than the cell asks for,
without the program beside the benchmark, or when a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Callable

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
PROGRAM = "realtime_yukarin_tpu_torch"
# top-level module names that may not be loaded in a run: JAX, and the JAX
# package the program was ported from (compared whole: the program's own
# name begins with it)
BANNED = ("jax", "jaxlib", "flax", "realtime_yukarin_tpu")


class RunError(Exception):
    """A run that cannot give a result (exit code ``code``)."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict            # configs/<config>.json
    traffic_name: str
    traffic: dict           # traffic/<mix>.json
    limits: dict            # checks/<workload>.json: {number: {limit, ...}}
    end_to_end: list        # this cell's end_to_end entries
    per_layer: list         # this cell's per_layer entries


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names or (
        "moves" not in metric)


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / cfg_entry["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(root / "benchmark" / "traffic"
                          / f"{w['traffic']}.json"),
        limits=load_json(root / "benchmark" / "checks"
                         / f"{workload}.json")["numbers"],
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: pathlib.Path = ROOT) -> Callable:
    """``metrics/<metric>.py``'s ``read``, loaded by its file name."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str, root: pathlib.Path = ROOT):
    """``drivers/<name>.py``, loaded by its file name."""
    path = root / "benchmark" / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.drivers.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


@dataclasses.dataclass
class Window:
    """What a cell's window gives back."""

    attempted: int
    failed: int
    metrics: dict           # end-to-end name -> value
    records: Any = None     # tracing.Records of the traced steps
    data: dict = dataclasses.field(default_factory=dict)  # for check()


@dataclasses.dataclass
class Context:
    """What a cell's set-up, window and check are given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any             # torch.device
    tracer: Any             # tracing.Tracer
    t0: float               # process start, time.perf_counter()

    phases: list = dataclasses.field(default_factory=list)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed on stderr)."""
        self.phases.append((name, time.perf_counter()))

    def rng_seed(self, *stream: int) -> list[int]:
        """A numpy SeedSequence entropy for one named random stream of
        this seed (any non-negative integer seed)."""
        return [self.seed, *stream]

    def torch_seed(self, stream: int) -> int:
        """A 63-bit torch.Generator seed for one stream of this seed."""
        import numpy as np
        return int(np.random.SeedSequence(self.rng_seed(stream))
                   .generate_state(2, np.uint32).astype(np.uint64)
                   .view(np.uint64)[0] >> np.uint64(1))


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative integer")
    if not args.seconds > 0:
        p.error("--seconds must be positive")
    return args


def require_cards(chips: int):
    """The card, or a RunError: no CPU fallback."""
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark measures the H100 "
                       "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def configure(device) -> None:
    """Float32 stays float32 (no TF32), and every build and kernel cache
    of the program lives at a fixed path inside the checkout."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))


def card_name(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        return q.stdout.strip() or q.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def held(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}).  A number
    that is missing or not finite fails."""
    out, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= spec["limit"]
        ok &= good
        out[name] = {"value": v, "limit": spec["limit"]}
    return ok, out


def per_layer_metrics(cell: Cell, records, root: pathlib.Path = ROOT
                      ) -> dict:
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], root)(records)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(argv: list[str], t0: float, device=None, root: pathlib.Path = ROOT
        ) -> dict:
    """One run; returns the result line's object.  ``device`` None: the
    card, required (the tests pass the CPU)."""
    args = parse_args(argv)
    if not (root / PROGRAM / "__init__.py").exists():
        raise RunError(f"the program ({PROGRAM}/) is not beside the "
                       f"benchmark in {root}")
    cell = load_cell(args.workload, root)
    if device is None:
        device = require_cards(cell.chips)
    configure(device)
    import torch

    from benchmark import tracing
    mod = driver(cell.traffic["driver"], root)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device,
                  tracer=tracing.Tracer(bool(args.trace),
                                        int(cell.traffic["trace_steps"]),
                                        device),
                  t0=t0)
    ctx.phase("imports")
    torch.empty(0, device=device)
    ctx.phase("device")
    state = mod.setup(ctx)
    setup_s = time.perf_counter() - t0
    last = t0
    for name, t in ctx.phases:
        print(f"[setup] {name}: {t - last:.3f} s", file=sys.stderr)
        last = t
    win = mod.window(ctx, state)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)
                                    if cuda else 0)}
    print(f"[bench] {cell.name} seed {args.seed}: "
          f"{card_name(device) if cuda else dev['kind']}", file=sys.stderr)
    correct, checks = held(mod.check(ctx, state, win), cell.limits)
    if args.trace:
        metrics = per_layer_metrics(cell, win.records, root)
        dev.update(busy_s=win.records.busy_s(),
                   window_s=win.records.window_s())
    else:
        metrics = {m["name"]: {"value": float(win.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = win.records.breakdown()
    result["checks"] = checks
    found = banned_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package were loaded: "
                       f"{found}", code=3)
    for name, c in checks.items():
        print(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result


def main(argv: list[str], t0: float) -> int:
    try:
        result = run(argv, t0)
    except RunError as e:
        print(f"[bench] no result: {e}", file=sys.stderr)
        return e.code
    print(json.dumps(result), flush=True)
    return 0
