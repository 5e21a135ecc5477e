"""BENCHMARK.json against the rules its harness and its check keep: names,
units and lines, the keys of each entry, every file a name points to, the
bounds and the length of a full check."""

import json
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_stays_under_paths():
    for word in BENCH["command"]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_sections():
    names = [m["name"] for s in ("end_to_end", "per_layer")
             for m in BENCH[s]]
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or "hidden" in k
                       for k in c["reduced"])


def test_workloads():
    wl = BENCH["workloads"]
    assert 1 <= len(wl) <= 24
    pairs = [(w["config"], w["traffic"]) for w in wl]
    assert len(pairs) == len(set(pairs))
    for w in wl:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        for d in ("traffic", "checks"):
            f = w["traffic"] if d == "traffic" else w["name"]
            assert (ROOT / "benchmark" / d / f"{f}.json").exists()
        driver = json.loads((ROOT / "benchmark" / "traffic"
                             / f"{w['traffic']}.json").read_text())["driver"]
        assert (ROOT / "benchmark" / "drivers" / f"{driver}.py").exists()
    assert sum(w["chips"] == 4 for w in wl) <= max(1, len(wl) // 4)


def test_end_to_end():
    names = {w["name"] for w in BENCH["workloads"]}
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", names)) <= names
    for w in names:
        cell = harness.load_cell(w)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_per_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    pl = BENCH["per_layer"]
    assert 1 <= len(pl) <= 128
    for m in pl:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  harness.load_cell(w).end_to_end}
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_full_check_fits_its_time():
    """2 + 14 runs per cell for the full 24 cells, each run_seconds + 60
    s, each cell 2 x 90 s to compile, 1200 s spare: within 43200 s."""
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
