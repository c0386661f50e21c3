"""BENCHMARK.json against the benchmark's contract, and the harness finding
every file a cell needs by name."""
import json
import re
from pathlib import Path

import pytest

from chipbench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert set(c["reduced"]) == set(body["changed_from_source"])
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))


def test_workloads():
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_fields(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if per_layer:
        assert _line(metric["layer"])
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_metric():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["unit"] == "s" and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
    layer = [m for m in BENCH["per_layer"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_a_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moved
    for cell in metric.get("workloads", CELLS):
        assert _reports(moved[0], cell)


def test_layers_are_named_alike():
    """One layer, one name: metrics whose layer names the same module give
    it letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    heads = [layer.split(" (")[0] for layer in layers]
    assert len(heads) == len(set(heads))


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_every_file_of_a_cell(cell):
    c = harness.cell(cell)
    assert c["config"]["name"] == c["entry"]["config"]
    assert (harness.HERE / "drivers" / f"{c['config']['mode']}.py").is_file()
    driver = harness.load_module(harness.HERE / "drivers" / f"{c['config']['mode']}.py")
    assert hasattr(driver, "Driver")
    assert set(c["cell"]["limits"]) and set(c["cell"]["traffic_params"])
    for mode in (0, 1):
        for m in c["metrics"][mode]:
            reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
            assert callable(reader.read)


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    readers = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in METRICS}


def test_benchmark_files_are_named_from_name_characters():
    for p in harness.HERE.rglob("*"):
        if "__pycache__" in p.parts or any(part.startswith(".") and part != ".gitignore"
                                           for part in p.relative_to(harness.HERE).parts):
            continue
        assert PATH.match(str(p.relative_to(ROOT))), p
