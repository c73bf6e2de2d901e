"""The check's model-specific steps belong to the configuration's family
(``families/<family>.py``).  The decoder family gives the readings and the
sample of the check as it stood before families (a frozen copy below) to
every digit, in a run and in the control; a configuration outside it (the
speech-LM fixture under ``speech_lm/``, which ``BENCHMARK.json`` names
nowhere: no ``flow`` or ``hift`` keys, prompts from a ``prompt`` traffic
block) runs through the same ``run_cell`` and ``control_readings``, is
correct, and each fault planted in it is not."""

import ast
import json
import time
from pathlib import Path

import pytest
import torch

from port_bench import run
from port_bench.control import control_readings
from port_bench.harness import check, spec, weights, window
from port_bench.harness.traffic import Traffic
from port_bench.tests.tiny import tiny_cells, with_reference

HERE = Path(__file__).resolve().parent
LM = HERE / "speech_lm"
SEED = 2**31 + 5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _decoder_cells():
    moss, v1 = tiny_cells()
    return {"moss": with_reference(moss, "moss_decoder_24k"),
            "v1": with_reference(v1, "cosyvoice1_decoder_22k")}


def _lm_cell():
    bench = json.loads((LM / "benchmark.json").read_text())
    return spec.resolve("lm_slots4", bench, LM)


def _keep(cell, fault=None):
    """``cell`` whose driver keeps its run and its served records in the
    returned dict, with ``fault(driver)`` planted after set-up."""
    mod = cell.driver()
    kept = {}

    class Kept(mod.Driver):
        def setup(self):
            super().setup()
            if fault is not None:
                fault(self)

        def run(self, seconds):
            kept["res"] = super().run(seconds)
            return kept["res"]

        def served(self):
            kept["served"] = super().served()
            return kept["served"]

    mod.Driver = Kept
    cell.driver = lambda: mod
    return kept


def _run(cell, seed=SEED):
    return run.run_cell(cell, seed, 2.0, False, "cpu",
                        t_start=time.perf_counter())


# ------------------------------------------------------------ frozen copies
def _frozen_run_check(cell, served, lengths, seed, device):
    """``run_cell``'s check as it stood before families (the served
    record's waveform, named ``wav`` then, is ``output`` now)."""
    check_mod = check
    sample = check_mod.choose(list(served), lengths,
                              cell.cell["check"]["sample"], seed)
    ref = cell.reference()
    flow_w, hift_w = weights.model_states(cell.config, seed, device)
    pcm16 = cell.cell["check"].get("pcm16", False)
    pairs = [(served[i].output, ref.decode(cell.config, flow_w, hift_w,
                                        served[i].tokens, served[i].speaker,
                                        device)) for i in sample]
    if pcm16:
        pairs = [(s, check_mod.pcm16(r)) for s, r in pairs]
    sr, hop = cell.config["hift"]["sampling_rate"], check_mod.frame_hop(
        cell.config)
    readings = check_mod.compare(pairs, sr, hop)
    each = check_mod.per_request(pairs, sr, hop)
    return sample, readings, each


def _frozen_control(cell, seed, device, precision, first):
    """``control_readings`` as it stood before families."""
    traffic = Traffic(cell.traffic, seed)
    reqs = [traffic.get(i) for i in range(first)]
    lengths = {r.index: r.n_tokens for r in reqs}
    sample = check.choose(list(lengths), lengths, cell.cell["check"]["sample"],
                          seed)
    ref = cell.reference()
    fw, hw = weights.model_states(cell.config, seed, device)
    pairs = []
    for i in sample:
        r = reqs[i]
        want = ref.decode(cell.config, fw, hw, r.tokens, r.speaker, device)
        got = ref.decode(cell.config, fw, hw, r.tokens, r.speaker, device,
                         precision=precision)
        if cell.cell["check"].get("pcm16"):
            want, got = check.pcm16(want), check.pcm16(got)
        pairs.append((got, want))
    sr, hop = cell.config["hift"]["sampling_rate"], check.frame_hop(
        cell.config)
    readings = check.compare(pairs, sr, hop)
    each = check.per_request(pairs, sr, hop)
    ok, _ = check.verdict(readings, cell.cell["check"]["limits"])
    return {"seed": seed, "precision": precision, "readings": readings,
            "passes_check": ok,
            "sample": [[i, lengths[i], *g] for i, g in zip(sample, each)]}


# ------------------------------------------------------------------ tests
def test_family_by_name_decoder_by_default(bench_root):
    bench, root = bench_root
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], bench, root)
        name = cell.config.get("family", "decoder")
        assert Path(cell.family().__file__) == root / "families" / (
            f"{name}.py")
    for cell in _decoder_cells().values():          # no family key
        assert "family" not in cell.config
        assert Path(cell.family().__file__) == spec.ROOT / "families" / (
            "decoder.py")
    lm = _lm_cell()
    assert not {"flow", "hift"} & set(lm.config)
    assert Path(lm.family().__file__) == LM / "families" / "logits.py"
    with pytest.raises(spec.SpecError):
        spec.resolve("lm_slots4", json.loads(
            (LM / "benchmark.json").read_text()))      # not under port_bench/


def test_run_and_control_reach_the_model_only_through_the_family():
    banned = {"flow", "hift", "frame_hop", "model_states", "decode", "wav"}
    for name in ("run.py", "control.py"):
        tree = ast.parse((spec.ROOT / name).read_text())
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Attribute)}
        names |= {n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert not names & banned, (name, names & banned)


@pytest.mark.parametrize("name", ["moss", "v1"])
def test_decoder_run_check_equals_frozen(name):
    cell = _decoder_cells()[name]
    kept = _keep(cell)
    out = _run(cell)
    assert out["correct"] is True, out["check"]
    res = kept["res"]
    counted = {r.index for r in window.sent_in(res.records, res.t0, res.t1)}
    served = {i: s for i, s in kept["served"].items() if i in counted}
    lengths = {i: s.tokens.shape[0] for i, s in served.items()}
    sample, readings, each = _frozen_run_check(cell, served, lengths, SEED,
                                               "cpu")
    assert out["readings"] == {k: run._finite(v) for k, v in readings.items()}
    assert out["sample"] == [[i, lengths[i], *[run._finite(v) for v in g]]
                             for i, g in zip(sample, each)]


@pytest.mark.parametrize("name,precision", [("moss", "fp8"),
                                            ("v1", "bfloat16")])
def test_decoder_control_equals_frozen(name, precision):
    cell = _decoder_cells()[name]
    got = control_readings(cell, SEED + 1, "cpu", precision, first=6)
    want = _frozen_control(cell, SEED + 1, "cpu", precision, 6)
    assert got == want
    assert got["readings"]["wav_gap"] > 0


def test_lm_fixture_run_is_correct():
    cell = _lm_cell()
    out = _run(cell)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert set(out["check"]) == {"logit_gap", "length_gap", "failed_requests"}
    assert {"setup_s", "audio_x_realtime", "first_audio_p95_ms",
            "request_rtf_p95"} == set(out["metrics"])
    assert len(out["sample"]) == cell.cell["check"]["sample"]
    json.dumps(out)


def test_lm_fixture_served_prompts_and_tokens():
    """Every served record holds its request's prompt and tokens and
    n_tokens + 1 rows of speech logits."""
    cell = _lm_cell()
    kept = _keep(cell)
    _run(cell)
    traffic = Traffic(cell.traffic, SEED)
    vocab = cell.config["speech_token_size"] + 3
    assert kept["served"]
    for i, s in kept["served"].items():
        req = traffic.get(i)
        assert (s.prompt == req.prompt).all() and len(s.prompt) >= 4
        assert (s.tokens == req.tokens).all()
        assert s.output.shape == (req.n_tokens + 1, vocab)


def test_lm_fixture_traced_run_reads_its_metric():
    cell = _lm_cell()
    out = run.run_cell(cell, SEED, 2.0, True, "cpu",
                       t_start=time.perf_counter())
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"lm.decode_step_ms"}
    assert out["metrics"]["lm.decode_step_ms"]["value"] > 0


def _lm_altered_weight(drv):
    with torch.no_grad():
        drv.lm.llm.layers[0].o_proj.weight[0, 0] += 0.5


def _lm_altered_output(drv):
    head = drv.lm.head
    drv.lm.head = lambda h: head(h) * 1.01


def _lm_state_unchanged(drv):
    """Every decode step leaves the slots' positions where they were."""
    step = drv.lm.llm.decode_step_slots
    drv.lm.llm.decode_step_slots = lambda emb, cache, advance=None: step(
        emb, cache, advance=torch.zeros_like(advance))


@pytest.mark.parametrize("fault", [_lm_altered_weight, _lm_altered_output,
                                   _lm_state_unchanged])
def test_lm_fixture_faults_fail_the_check(fault):
    cell = _lm_cell()
    _keep(cell, fault)
    out = _run(cell)
    assert out["correct"] is False, out["check"]


def test_lm_fixture_control_fails_the_check():
    cell = _lm_cell()
    out = control_readings(cell, SEED, "cpu", first=16)
    assert out["precision"] == "bfloat16"
    assert out["passes_check"] is False, out
