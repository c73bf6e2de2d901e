"""The references' precisions at the tiny presets on the CPU: float32 and
TF32 (no TF32 on a CPU) agree, and rounding every tensor of the model to
bf16, and further to fp8, moves the waveform further each time."""

import numpy as np
import pytest
import torch

from port_bench.harness import check, weights
from port_bench.harness.traffic import Traffic
from port_bench.tests.tiny import tiny_cells, with_reference


@pytest.fixture(scope="module")
def moss():
    cell = with_reference(tiny_cells()[0], "moss_decoder_24k")
    fw, hw = weights.model_states(cell.config, 7, "cpu")
    req = Traffic(cell.traffic, 7).get(0)
    ref = cell.reference()

    def decode(precision):
        return ref.decode(cell.config, fw, hw, req.tokens, req.speaker,
                          "cpu", precision=precision)
    return decode


def test_precisions_order(moss):
    f32 = moss("float32")
    assert np.array_equal(f32, moss("tf32"))
    gaps = {p: check.wav_gap(moss(p), f32) for p in ("bfloat16", "fp8")}
    assert 0 < gaps["bfloat16"] < gaps["fp8"]


def test_unknown_precision_refused():
    from port_bench.reference import plain
    with pytest.raises(ValueError):
        plain.Ops("float16")


def test_fp8_keeps_infinities():
    from port_bench.reference import plain
    x = torch.tensor([1.0, -float("inf"), 3.0])
    y = plain._fp8(x)
    assert y[1] == -float("inf") and torch.isfinite(y[[0, 2]]).all()
