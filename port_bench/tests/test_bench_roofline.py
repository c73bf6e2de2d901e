"""The frozen roofline formulas reproduce the bound column of the kernel
table in PERF.md (H100 SXM peaks)."""

import pytest

from port_bench.harness import roofline as R

LANES = ((40, 41, 1 << 30, 0), (3, 4, 1 << 30, 40), (18, 21, 12, 0),
         (5, 5, 1 << 30, 20))


def _mid(rows, nd, en, dtype):
    return 1e3 * R.group_bound_s(rows, 20, 256, 256, 512, 1024, 1024, 4, 160,
                                 nd, en, dtype)


def test_fused_tf_group_mid_group_20_rows():
    assert _mid(20, [180] * 20, [1] * 20, "bfloat16") == pytest.approx(
        0.0109, abs=5e-5)
    assert _mid(20, [180] * 20, [1] * 20, "float32") == pytest.approx(
        0.0635, abs=5e-5)


@pytest.mark.parametrize("lanes,bf16,f32", [
    (1, 0.0109, 0.0635), (2, 0.0146, 0.1228), (3, 0.0226, 0.1863),
    (4, 0.0262, 0.2455)])
def test_fused_tf_group_per_row_lanes(lanes, bf16, f32):
    nd, en = R.lanes_tick_rows(LANES[:lanes], 10, 20)
    assert _mid(len(nd), nd, en, "bfloat16") == pytest.approx(bf16, abs=5e-5)
    assert _mid(len(nd), nd, en, "float32") == pytest.approx(f32, abs=5e-5)


@pytest.mark.parametrize("t,chunk,dtype,want", [
    (1000, 0, "bfloat16", 0.00414), (1000, 0, "float32", 0.0611),
    (1119, 0, "float32", 0.0766), (1119, 0, "bfloat16", 0.00519),
    (560, 0, "float32", 0.0192), (560, 0, "bfloat16", 0.00137),
    (160, 50, "bfloat16", 0.00039)])
def test_flash_chunk_attention(t, chunk, dtype, want):
    got = 1e3 * R.attention_bound_s(2, 8, t, 64, chunk, t, dtype)
    assert got == pytest.approx(want, rel=2e-2)


def test_peaks_by_precision():
    assert R.peak_flops({"compute_dtype": "bfloat16"}) == 989e12
    assert R.peak_flops({"compute_dtype": "float32", "tf32": False}) == 67e12
    assert R.peak_flops({"compute_dtype": "float32", "tf32": True}) == 495e12
