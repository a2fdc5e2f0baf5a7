"""BENCHMARK.json against the benchmark's contract, and every name in it
leading to its files: run with ``python -m pytest benchmark/tests -q``."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def names():
    for c in SPEC["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_keys_units_and_lines():
    assert set(SPEC) == KEYS
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(
        PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    lines = [c["source"] for c in SPEC["configs"]] + [
        x["why"] for x in SPEC["configs"] + SPEC["workloads"]] + [
        m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    assert all(1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
               for s in lines)
    for group in ("configs", "workloads", "end_to_end"):
        listed = [x["name"] for x in SPEC[group]]
        assert len(listed) == len(set(listed))
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])


def test_run_seconds_fit_a_check_of_24_cells():
    seconds = SPEC["run_seconds"]
    assert 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        cell = harness.find_cell(SPEC, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(workload):
    cell = harness.find_cell(SPEC, workload)
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == cell.workload["config"])
    assert entry["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    assert cell.config["source"] == entry["source"]
    assert cell.config["reduced"] == entry["reduced"]
    assert hasattr(harness.loop(cell.traffic["loop"]), "Loop")
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    assert cell.limits, f"no limits/{workload}.json"


def test_configuration_files_are_distinct_and_run_as_the_program_reads_them():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        config = json.loads((harness.ROOT / c["file"]).read_text())["config"]
        harness.port_config(config, 2 ** 31 + 5)


def test_a_new_configuration_mix_and_metric_are_only_new_files(tmp_path):
    """In a copy of the benchmark, one configuration, one traffic mix, one
    per-layer metric and one cell's limits are added as new files and
    entries: the harness finds each by its name, edits to no file."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = root / "benchmark"
    (bench / "configs" / "gennbv_new.json").write_text(
        (bench / "configs" / "gennbv_ref400.json").read_text())
    (bench / "traffic" / "new_mix.json").write_text(
        (bench / "traffic" / "ppo_train.json").read_text())
    (bench / "metrics" / "new_layer.train.py").write_text(
        'READS = ("time/gae",)\n\n\ndef read(rec):\n'
        '    return rec["phases"][0]["time/gae"]\n')
    (bench / "limits" / "new.cell.json").write_text(
        (bench / "limits" / "flagship128.train.json").read_text())
    spec["configs"].append({"name": "gennbv_new", "source": "https://x.org",
                            "file": "benchmark/configs/gennbv_new.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "new.cell", "config": "gennbv_new",
                              "traffic": "new_mix", "chips": 1, "why": "t"})
    spec["end_to_end"][0].setdefault("workloads", []).append("new.cell")
    spec["per_layer"].append({"name": "new_layer.train", "unit": "s",
                              "better": "lower", "source": "program_span",
                              "layer": "GAE", "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell(harness.load_spec(root), "new.cell", bench)
    assert cell.config["config"]["env"]["camera"]["height"] == 400
    assert cell.traffic["loop"] == "train"
    assert [m["name"] for m in cell.per_layer] == ["new_layer.train"]
    reader = harness.metric_reader("new_layer.train", bench)
    assert reader.read({"phases": [{"time/gae": 0.5}]}) == 0.5
    assert cell.limits == json.loads(
        (harness.BENCH / "limits" / "flagship128.train.json").read_text())
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_paths_hold_only_the_benchmark():
    allowed = {".py", ".json", ".md"}
    for p in Path(harness.BENCH).rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert p.suffix in allowed, p


def test_a_profile_is_cut_to_a_part_of_its_run():
    """``trace.cut`` places two events of the run by their time after the
    profile's origin (the leading pads' end) and keeps the records in
    between, clipped to them."""
    from benchmark import trace

    class Origin:
        def elapsed_time(self, event):      # milliseconds, as CUDA's
            return event

    spans = [trace.Span("a", 1_000, 2_000_000), trace.Span("b", 2_500_000,
                                                           3_000_000),
             trace.Span("c", 3_500_000, 6_000_000),
             trace.Span("d", 6_500_000, 7_000_000)]
    prof = trace.Profile(None, spans, (1_000, 8_000_000), [], Origin())
    part = trace.cut(prof, 1.0, 5.0)
    assert part.window == (1_001_000, 5_001_000)
    assert part.spans == [trace.Span("a", 1_001_000, 2_000_000),
                          trace.Span("b", 2_500_000, 3_000_000),
                          trace.Span("c", 3_500_000, 5_001_000)]
    assert trace.busy_ns(part.spans) == 999_000 + 500_000 + 1_501_000
