"""BENCHMARK.json against the contract's form, and the harness's lookup of
cells, configurations, loops and metrics by name."""

import json
import re

import pytest

from stbench import manifest
from stbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = json.loads((REPO / "BENCHMARK.json").read_text())
METRICS = B["end_to_end"] + B["per_layer"]


def test_names_and_units_use_the_allowed_characters():
    names = ([m["name"] for m in METRICS] + [c["name"] for c in B["configs"]]
             + [w["name"] for w in B["workloads"]] + [w["traffic"] for w in B["workloads"]]
             + [k for c in B["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in ([w["why"] for w in B["workloads"]] + [m["layer"] for m in B["per_layer"]]
                 + [c["source"] for c in B["configs"]] + B["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in (METRICS, B["configs"], B["workloads"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    for w in B["workloads"]:
        cell = manifest.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # each layer metric's cell reports what it moves
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_bounds_sources_and_run_length_keep_to_the_contract():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert [m for m in B["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m
    assert 1 <= B["run_seconds"] <= 51
    cells = 24  # what later PRs may grow to: it has to fit the check's 43200 s
    assert (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert all(w["chips"] == 1 for w in B["workloads"])


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_every_cell_loads_into_a_stylize_config(name):
    cell = manifest.load_cell(name)
    fields = cell.stylize()
    fields.setdefault("iterations", [50])
    cfg = manifest.stylize_config(fields)
    assert cfg.use_fused and cfg.chunk_size == cell.workload["stylize"]["chunk_size"]
    assert cfg.optimizer.name == cell.config["stylize"]["optimizer"]["name"]
    assert cell.config_entry["file"].startswith("stbench/")
    assert set(cell.config_entry["reduced"]) == set(cell.config["reduced"])
    assert manifest.loop(cell.workload["loop"]).run


def test_every_per_layer_metric_has_a_reader():
    for m in B["per_layer"]:
        assert callable(manifest.metric_reader(m["name"])), m["name"]


def test_a_cell_defined_by_a_new_file_alone_is_found(tiny_root):
    cell = manifest.load_cell("tiny-adam", tiny_root)
    assert cell.stylize()["size"] == 64 and cell.config["stylize"]["optimizer"]["name"] == "adam"
    assert {m["name"] for m in cell.end_to_end} == {"its_per_s", "peak_mib", "setup_s"}
    with pytest.raises(KeyError):
        manifest.load_cell("no-such-cell", tiny_root)


def test_a_metric_defined_by_a_new_file_alone_is_found(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new_metric.steady.py").write_text(
        "def read(run):\n    return run['window_its'] * 2.0\n")
    monkeypatch.setattr(manifest, "PACKAGE", tmp_path)
    assert manifest.metric_reader("new_metric.steady")({"window_its": 3}) == 6.0
    assert manifest.metric_reader("absent") is None


def test_an_unknown_stylize_field_is_refused():
    with pytest.raises(ValueError, match="not StylizeConfig"):
        manifest.stylize_config({"optimizer": {"name": "adam"}, "sise": 3})
