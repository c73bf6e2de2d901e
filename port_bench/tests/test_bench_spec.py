"""The harness finds every configuration, cell, traffic mix, driver,
reference, family and metric reader by name, refuses unknown names, and
``BENCHMARK.json`` keeps the contract's shape; each over the listed cells
and over them with the speech-LM fixture added (``bench_root``)."""

import json
import re

import pytest

from port_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench(bench_root):
    return bench_root[0]


@pytest.fixture(scope="module")
def root(bench_root):
    return bench_root[1]


def test_every_cell_resolves(bench, root):
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], bench, root)
        assert cell.chips == w["chips"]
        assert hasattr(cell.driver(), "Driver")
        assert cell.reference().__file__ == str(
            root / "reference" / f"{w['config']}.py")
        fam = cell.family()
        assert all(callable(getattr(fam, f, None)) for f in (
            "states", "reference_output", "compare"))
        readers = cell.readers()
        assert readers and all(hasattr(r, "read") for r in readers.values())
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


@pytest.mark.parametrize("name", ["no_such_cell", "bad name", "../x", ""])
def test_unknown_names_refused(bench, root, name):
    with pytest.raises(spec.SpecError):
        spec.resolve(name, bench, root)


def test_missing_files_refused(bench, root):
    for w in range(len(bench["workloads"])):
        b = json.loads(json.dumps(bench))
        b["workloads"][w]["traffic"] = "no_such_traffic"
        with pytest.raises(spec.SpecError):
            spec.resolve(b["workloads"][w]["name"], b, root)
        b = json.loads(json.dumps(bench))
        b["workloads"][w]["config"] = "no_such_config"
        with pytest.raises(spec.SpecError):
            spec.resolve(b["workloads"][w]["name"], b, root)


def test_readers_declare_their_metric(bench, root):
    """A reader declares its layer, the metric it moves, and the cells in
    which it finds something to read; ``BENCHMARK.json`` reports it in
    some of those."""
    for m in bench["per_layer"]:
        mod = spec.load_module(root / "metrics" / f"{m['name']}.py",
                               m["name"])
        assert mod.LAYER == m["layer"]
        assert mod.MOVES == m["moves"]
        assert set(m["workloads"]) <= set(mod.WORKLOADS)


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_cell_files_agree(bench, root):
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], bench, root)
        assert cell.cell["why"] == w["why"]
        assert "length_gap" in cell.cell["check"]["limits"]
