"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its traffic
mix; the files are looked up by name, never listed in code, so a later change
adds a cell, a configuration, a traffic mix or a per-layer metric by adding
files only:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: the entry driver, its options and the sample of
  outputs the check compares;
- ``traffic/<traffic>.json``: the parameters of the general generator
  (``traffic.py``);
- ``drivers/<driver>.py``: the entry driver (a ``Driver`` class);
- ``reference/<config>.py``: the plain reference of the configuration;
- ``families/<family>.py``: the check's model-specific steps (the seeded
  weights, the reference output of a served request, the readings), named
  by the configuration's ``family`` key, ``decoder`` where it names none;
- ``metrics/<metric>.py``: one per-layer metric's reader (``read(run)``).

Every directory is looked up under the cell's ``root`` (``port_bench/``);
a test fixture laid out the same way elsewhere passes its own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]          # port_bench/
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """An unknown or malformed name, or a file that is missing."""


def _name(kind: str, value) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise SpecError(f"{kind} {value!r} is not a valid name")
    return value


def _missing(path: Path) -> SpecError:
    shown = path.relative_to(REPO) if path.is_relative_to(REPO) else path
    return SpecError(f"missing file {shown}")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise _missing(path)
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str) -> ModuleType:
    """The Python file at ``path`` as a module (names may hold dots)."""
    if not path.is_file():
        raise _missing(path)
    safe = "port_bench_" + re.sub(r"[^A-Za-z0-9_]", "_", label)
    spec = importlib.util.spec_from_file_location(safe, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell resolved: its entries and files."""
    name: str
    entry: dict                 # the BENCHMARK.json workload entry
    config: dict                # configs/<config>.json
    cell: dict                  # workloads/<cell>.json
    traffic: dict               # traffic/<traffic>.json
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    root: Path = ROOT           # the directory the files below are under

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self) -> ModuleType:
        name = _name("driver", self.cell["driver"])
        return load_module(self.root / "drivers" / f"{name}.py",
                           f"driver_{name}")

    def reference(self) -> ModuleType:
        name = _name("config", self.entry["config"])
        return load_module(self.root / "reference" / f"{name}.py",
                           f"ref_{name}")

    def family(self) -> ModuleType:
        name = _name("family", self.config.get("family", "decoder"))
        return load_module(self.root / "families" / f"{name}.py",
                           f"family_{name}")

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(
            self.root / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
            for m in self.per_layer}


def benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return _json(path)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` of ``bench`` (``BENCHMARK.json``), its
    files under ``root``; raises ``SpecError`` for an unknown name or a
    missing file."""
    bench = bench if bench is not None else benchmark()
    _name("workload", workload)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SpecError(f"unknown workload {workload!r}; known: "
                        f"{sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cname = _name("config", entry["config"])
    if cname not in configs:
        raise SpecError(f"workload {workload!r} names unknown config "
                        f"{cname!r}")
    config = _json(REPO / configs[cname]["file"])
    traffic = _json(root / "traffic" / f"{_name('traffic', entry['traffic'])}"
                    ".json")
    cell = _json(root / "workloads" / f"{workload}.json")
    if cell.get("config") != cname or cell.get("traffic") != entry["traffic"]:
        raise SpecError(f"workloads/{workload}.json disagrees with "
                        f"BENCHMARK.json on its config or traffic")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, entry, config, cell, traffic, e2e, layer, root)
