"""The control of each cell's check, on the card at the cell's own size:
the plain reference computed one precision below the configuration's (the
cell's ``check.control``: fp8 for the bf16 MOSS decoder) has to come out as
not correct.  Run on the chip with
``python -m pytest port_bench/tests/test_bench_control.py -m cuda``; it
skips without a card."""

import pytest

from port_bench.control import control_readings
from port_bench.harness import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "full size")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_control_fails_the_check(card, workload):
    cell = spec.resolve(workload)
    out = control_readings(cell, 2**31 + 101, card, first=32)
    assert out["passes_check"] is False, out
