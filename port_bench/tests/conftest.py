"""``bench_root``: the tests that hold every listed cell run over
``BENCHMARK.json`` as it stands, and over a copy to which the speech-LM
fixture (``speech_lm/``) is added as a configuration outside the decoder
family would be added: its configuration, cell and per-layer metric
appended, its files beside ``port_bench/``'s.  So such a configuration needs
no edit of these tests."""

import json
import shutil
from pathlib import Path

import pytest

from port_bench.harness import spec

LM = Path(__file__).resolve().parent / "speech_lm"
DIRS = ("drivers", "families", "metrics", "reference", "traffic",
        "workloads")


def with_speech_lm(dest: Path):
    """(bench, root): ``BENCHMARK.json`` with the fixture's entries added,
    and ``dest`` holding a copy of ``port_bench/``'s files and the
    fixture's."""
    skip = shutil.ignore_patterns("__pycache__")
    for d in DIRS:
        shutil.copytree(spec.ROOT / d, dest / d, ignore=skip)
        if (LM / d).is_dir():
            shutil.copytree(LM / d, dest / d, ignore=skip, dirs_exist_ok=True)
    bench = spec.benchmark()
    extra = json.loads((LM / "benchmark.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        bench[key] = bench[key] + extra[key]
    have = {m["name"] for m in bench["end_to_end"]}
    bench["end_to_end"] += [m for m in extra["end_to_end"]
                            if m["name"] not in have]
    return bench, dest


@pytest.fixture(scope="module", params=["listed", "with_speech_lm"])
def bench_root(request, tmp_path_factory):
    if request.param == "listed":
        return spec.benchmark(), spec.ROOT
    return with_speech_lm(tmp_path_factory.mktemp("bench"))
