"""BENCHMARK.json against the benchmark's contract: names and units in their
alphabets, every file the manifest points at present, every per-layer metric
reported where its end-to-end metric is, and the run length inside the
check's time."""

import json
import re

import pytest

from portbench import cell as cells
from portbench import run

MANIFEST = json.loads((cells.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[section]:
            yield e["name"]
    for w in MANIFEST["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in MANIFEST["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_keep_to_the_alphabet(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert METRIC_KEYS <= set(metric)
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= METRIC_KEYS | {"bound", "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert set(metric) <= METRIC_KEYS | {"layer", "moves", "workloads"}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert (cells.ROOT / "metrics" / f"{metric['name']}.py").is_file()


def test_names_are_unique():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    cells_of = metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])
    for w in cells_of:
        assert metric["moves"] in run.reported_end_to_end(MANIFEST, w), (metric["name"], w)


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(w):
    rep = run.reported_end_to_end(MANIFEST, w["name"])
    assert "setup_s" in rep and len(rep) >= 2
    assert run.wanted_metrics(MANIFEST, w["name"], rep)
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert (cells.ROOT / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    path = cells.REPO / c["file"]
    cfg = json.loads(path.read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert path.with_suffix(".py").is_file()
    assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_paths_and_command():
    assert MANIFEST["paths"] == ["portbench"]
    assert len(MANIFEST["command"]) <= 32
    assert not any(a.startswith("/") or ".." in a for a in MANIFEST["command"])


def test_run_length_fits_a_full_check_of_24_cells():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_manifest_size():
    assert len((cells.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
