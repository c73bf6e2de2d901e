"""The port's remaining tools against the JAX package's, on the CPU at the
tiny configs: ``utils/profiling.py``, ``utils/export.py`` and the
measurement CLIs (``bin/ablate_block.py``, ``bin/ablate_dtype.py``,
``bin/profile_wave.py``, ``bin/profile_tail.py``,
``bin/analyze_wave_copies.py``, the counterpart of
``analyze_wave_hlo.py``).

- ``LatencyStats.summary()`` equal to JAX's on the same samples;
  ``trace`` writes a Chrome trace that holds the block's ops;
- the export round trip (``torch.export``) equal to the eager call within
  1e-6; ``aot_compile`` raises off a card (it captures a CUDA graph);
- ``_mcd_db`` equal to JAX's (1e-6 relative) on the same arrays;
- each CLI runs at ``--config tiny --device cpu`` and prints the JAX
  tool's keys; ``ablate_block`` without ``--random-init`` raises with its
  reason; ``profile_wave`` reports the kernel's limit for a bf16 chunk
  over 32 frames and times no other engine under the kernel's name.

Torch runs on one thread."""

import json

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_torch.bin import ablate_block, ablate_dtype
from moss_speech_decoder_cosy_torch.bin import analyze_wave_copies
from moss_speech_decoder_cosy_torch.bin import profile_tail, profile_wave
from moss_speech_decoder_cosy_torch.utils import export as EX
from moss_speech_decoder_cosy_torch.utils import profiling as PR

TINY = ["--config", "tiny", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_latency_stats_summary_matches_jax():
    from moss_speech_decoder_cosy_tpu.utils.profiling import (
        LatencyStats as JStats)
    rng = np.random.RandomState(0)
    samples = {"frame": list(rng.gamma(2.0, 3.0, 97)),
               "chunk": list(rng.rand(5) * 40)}
    got, want = PR.LatencyStats(), JStats()
    got.samples = {k: list(v) for k, v in samples.items()}
    want.samples = {k: list(v) for k, v in samples.items()}
    assert got.summary() == want.summary()
    s = PR.LatencyStats(capacity=3)
    for _ in range(5):
        with s.measure("x"):
            pass
    assert s.summary()["x"]["n"] == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    lin = torch.nn.Linear(8, 4)
    with PR.trace(str(tmp_path)) as t:
        with PR.annotate("tiny_linear"):
            lin(torch.randn(3, 8))
    names = {e.get("name") for e in json.loads(open(t.path).read())[
        "traceEvents"]}
    assert "tiny_linear" in names and "aten::linear" in names
    assert t.wall_s > 0


def test_export_round_trip_equals_eager():
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, tiny_speech_lm_config)
    from moss_speech_decoder_cosy_torch.weights import seeded_module
    lm = seeded_module(lambda: Qwen2SpeechLM(tiny_speech_lm_config()), 0,
                       "cpu").eval()
    x = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(1))
    blob = EX.export_serialized(lm.llm.forward_causal, x)
    assert isinstance(blob, bytes) and len(blob) > 1000
    fn = EX.load_serialized(blob)
    with torch.no_grad():
        want = lm.llm.forward_causal(x)
        np.testing.assert_allclose(fn(x).numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)
        x2 = torch.randn(2, 7, 32)
        np.testing.assert_allclose(fn(x2).numpy(),
                                   lm.llm.forward_causal(x2).numpy(),
                                   atol=1e-6, rtol=0)


def test_aot_compile_raises_off_a_card():
    with pytest.raises(ValueError, match="CUDA graph.*cpu"):
        EX.aot_compile(torch.tanh, torch.zeros(3))


def test_mcd_matches_jax():
    from moss_speech_decoder_cosy_tpu.bin.ablate_block import _mcd_db
    rng = np.random.RandomState(2)
    a = rng.randn(1, 50, 80).astype(np.float32)
    b = a + 0.1 * rng.randn(1, 50, 80).astype(np.float32)
    np.testing.assert_allclose(ablate_block._mcd_db(a, b), _mcd_db(a, b),
                               rtol=1e-6)


def test_ablate_block_random_init_blocks(capsys):
    out = ablate_block.main(["--random-init", "2", "3", "--tokens", "30"]
                            + TINY)
    assert set(out) == {"protocol", "mean_abs_golden", "blocks"}
    assert set(out["blocks"]) == {2, 3}
    for row in out["blocks"].values():
        assert set(row) == {"ring_tokens", "mcd_db", "band_rel_max",
                            "band_rel_mean", "rel_mae"}
        assert np.isfinite(row["mcd_db"]) and row["rel_mae"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))


def test_ablate_block_without_random_init_raises():
    with pytest.raises(RuntimeError, match="reference checkout"):
        ablate_block.main(TINY)


def test_ablate_dtype_prints_the_recipes():
    out = ablate_dtype.main(["--tokens", "20"] + TINY)
    assert set(out) == {"mean_abs_golden", "bf16_old", "bf16_f32ode",
                        "bf16_est", "bf16_enc"}
    for name in ("bf16_old", "bf16_f32ode", "bf16_est", "bf16_enc"):
        assert set(out[name]) == {"mel_mae", "rel"} and out[name]["rel"] > 0


def test_profile_wave_rows_and_kernel_limit():
    rows = profile_wave.main(["--seconds", "3", "--runs", "2", "--configs",
                              "kernel:5:35,concat:5:35,kernel:10:30"] + TINY)
    k, c, limit = rows
    for row in (k, c):
        assert {"iters", "scan_s", "ms_per_iter", "scan_rtf",
                "runs"} <= set(row) and len(row["runs"]) == 2
        assert row["ms_per_iter"] > 0
    assert k["engine"] == "kernel" and c["engine"] == "concat"
    assert "chunks of at most 32 frames, got 40" in limit["kernel_limit"]
    assert "scan_s" not in limit


def test_profile_tail_phases():
    out = profile_tail.main(["--seconds", "3", "--runs", "1"] + TINY)
    for mode in ("graphed", "eager"):
        assert set(profile_tail.PHASES) <= set(out[mode])
        assert out[mode]["wavefront"] > 0 and out[mode]["unfenced_wall_ms"] > 0


def test_copy_audit_keys():
    out = analyze_wave_copies.main(["--seconds", "4"] + TINY)
    assert {"copies", "bytes_per_iter", "by_shape", "by_op"} <= set(out)
    assert out["copies"] > 0 and out["bytes_per_iter"] > 0
    assert sum(b for _, b in out["by_op"].values()) == out["bytes_per_iter"]
