"""A short CPU run of each driver at the port's tiny presets through the
harness (its look for a card skipped): the result line's keys, the check
against the plain reference, and each fault the cell can have, planted
under the timed path, coming out as not correct."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import run
from port_bench.tests.tiny import tiny_cells, with_reference

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cells():
    moss, v1 = tiny_cells()
    return {"moss": with_reference(moss, "moss_decoder_24k"),
            "v1": with_reference(v1, "cosyvoice1_decoder_22k")}


def _run(cell, trace=False, fault=None, seed=2**31 + 5):
    """One run of ``cell`` on the CPU; ``fault(driver)`` breaks the
    program after set-up."""
    if fault is not None:
        mod = cell.driver()
        base = mod.Driver.setup

        class Broken(mod.Driver):
            def setup(self):
                base(self)
                fault(self)

        mod.Driver = Broken
        cell.driver = lambda: mod
    return run.run_cell(cell, seed, 2.0, trace, "cpu",
                        t_start=time.perf_counter())


@pytest.mark.parametrize("name", ["moss", "v1"])
def test_run_line_and_check(name):
    out = _run(_cells()[name])
    assert list(out)[:5] == KEYS and list(out)[-1] == "check"
    json.dumps(out)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"setup_s", "audio_x_realtime", "first_audio_p95_ms",
            "request_rtf_p95"} == set(out["metrics"])
    assert out["device"]["platform"] == "cpu"
    for name, v in out["check"].items():
        assert v["value"] <= v["limit"], name


def test_traced_run_reads_span_metrics():
    out = _run(_cells()["moss"], trace=True)
    assert out["correct"] is True
    assert {"engine.admit_ms", "batcher.tick_ms", "decode_mfu"} <= set(
        out["metrics"])
    assert "audio_x_realtime" not in out["metrics"]


def _alter_tokens(drv):
    b = drv.engine.batcher
    push = b.push
    b.push = lambda lane, tokens: push(
        lane, (np.asarray(tokens) + 1) % drv.cell.traffic["vocab"])


def _alter_answer(drv):
    b = drv.engine.batcher
    pump = b.pump
    b.pump = lambda max_iters=8: {k: v * 0.5 for k, v in
                                  pump(max_iters=max_iters).items()}


def _drop_half_the_lanes(drv):
    b = drv.engine.batcher
    emit = b._emit
    b._emit = lambda lane, st, mel: emit(
        lane, st, mel * 0.0 if lane % 2 else mel)


def _vocoder_state_unchanged(drv):
    """The steady vocoder hop returns its lane's caches as they were."""
    b = drv.engine.batcher

    def step():
        lane = b._lane_idx
        wav, _ = b._vocode(b._voc_in, b._voc_state(lane), False, False,
                           b._voc_draws)
        b._voc_out.copy_(wav)

    b._voc_step_impl = step


@pytest.mark.parametrize("fault", [_alter_tokens, _alter_answer,
                                   _drop_half_the_lanes,
                                   _vocoder_state_unchanged])
def test_engine_faults_fail_the_check(fault):
    out = _run(_cells()["moss"], fault=fault)
    assert out["correct"] is False, out["check"]


def _v1_alter_tokens(drv):
    dec = drv.dec
    t2w = dec.token2wav
    dec.token2wav = lambda tok, **kw: t2w((np.asarray(tok) + 1) % 64, **kw)


def _v1_alter_answer(drv):
    dec = drv.dec
    t2w = dec.token2wav
    dec.token2wav = lambda tok, **kw: t2w(tok, **kw) * 0.5


def _v1_drop_cfg_half(drv):
    est = drv.dec.flow.decoder.estimator
    fwd = est.forward

    def half(x, *a, **kw):
        out = fwd(x, *a, **kw)
        b = out.shape[0] // 2
        return torch.cat([out[:b], out[:b]])

    est.forward = half


def _v1_euler_state_unchanged(drv):
    """Every Euler step returns the ODE state it was given."""
    drv.dec.flow.decoder.euler_step = lambda x, *a, **kw: x


@pytest.mark.parametrize("fault", [_v1_alter_tokens, _v1_alter_answer,
                                   _v1_drop_cfg_half,
                                   _v1_euler_state_unchanged])
def test_token2wav_faults_fail_the_check(fault):
    out = _run(_cells()["v1"], fault=fault)
    assert out["correct"] is False, out["check"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "moss_serve16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_unknown_workload_no_result():
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "nope",
         "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
