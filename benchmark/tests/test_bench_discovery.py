"""A configuration, a traffic mix and a per-layer metric dropped into a
copy of the benchmark as new files, with their entries in BENCHMARK.json,
are found by name and run, and no file that was there changes."""

import hashlib
import json


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing_any(tiny_root, run_tiny):
    root = tiny_root
    before = _digests(root)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "default.json").read_text())
    cfg["name"] = "narrow"
    cfg["config"]["super_resolution"]["num_blocks"] = 1
    cfg["reduced"] = ["super_resolution"]
    (b / "configs" / "narrow.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "serve512.json").read_text())
    mix.update(lanes=4, pause_share=0.0)
    (b / "traffic" / "calm4.json").write_text(json.dumps(mix))
    (b / "checks" / "narrow.calm4.json").write_text(
        (b / "checks" / "default.serve512.json").read_text())
    (b / "metrics" / "ticks_traced.serve.py").write_text(
        "def read(rec):\n    return None if rec is None else rec.steps\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "narrow", "source": "https://example.org/narrow",
        "file": "benchmark/configs/narrow.json",
        "reduced": ["super_resolution"], "why": "a test's configuration"})
    bench["workloads"].append({
        "name": "narrow.calm4", "config": "narrow", "traffic": "calm4",
        "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "default.serve512" in m.get("workloads", []):
            m["workloads"].append("narrow.calm4")
    bench["per_layer"].append({
        "name": "ticks_traced.serve", "unit": "ticks", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "xrealtime", "workloads": ["narrow.calm4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run_tiny(root, "narrow.calm4", seconds=5.0, trace=1)
    assert res["metrics"]["ticks_traced.serve"]["value"] == 2
    res = run_tiny(root, "narrow.calm4")
    assert {"xrealtime", "chunk_ms_p95", "setup_s"} <= set(res["metrics"])
    after = _digests(root)
    assert {k: after[k] for k in before} == before
