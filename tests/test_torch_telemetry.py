"""The port's telemetry store (``utils/profiling.py``) and what the decode
server records into it, on the CPU at tiny configs, f32:

- the store: nested spans carry their parent's and their request's ids,
  also across asyncio tasks; a span's self time is its duration less the
  part its children cover; the rings stay bounded; with ``enabled`` off
  nothing is recorded;
- a span opens a region of ``torch.profiler``'s trace while a profiler
  records, and only then;
- the engine: four concurrent ``decode_stream`` requests over two lanes:
  each request's stamps in order and inside its client's send -> first
  chunk, ``engine.queue_ms`` + ``batcher.first_chunk_ms`` its ``open`` ->
  first chunk, at least S ticks to a first chunk, the pump's phases inside
  their pump, ``batcher.rows_computed`` S x 2 x lanes a tick and
  ``batcher.rows_useful`` the sum of the wavefront's per-row write flags;
  the audio bit for bit the same with the store on and off;
- ``boot_warmup_batcher`` leaves nothing for a served request to capture;
- the benchmark's readers at the tiny preset: a traced
  ``port_bench.run.run_cell`` reads every new metric the CPU can give, and
  a program without the store reads as nothing."""

import asyncio
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_torch.models.flow import kv_stream
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
from moss_speech_decoder_cosy_torch.serving import audio_batcher as AB
from moss_speech_decoder_cosy_torch.serving.boot import boot_warmup_batcher
from moss_speech_decoder_cosy_torch.utils import config as C
from moss_speech_decoder_cosy_torch.utils import profiling as PR
from moss_speech_decoder_cosy_torch.utils.profiling import (TELEMETRY,
                                                            LatencyStats)
from moss_speech_decoder_cosy_torch.weights import seeded_states

HOP, RING, S, PUMP_ITERS = 2, 7, 3, 2
NEW_METRICS = ("engine.queue_ms", "batcher.first_chunk_ms",
               "batcher.first_chunk_ticks", "engine.pump_gap_ms",
               "batcher.enc_ms", "batcher.wave_ms", "batcher.voc_ms",
               "batcher.finalize_ms", "batcher.useful_rows",
               "graphs.launch_ms")
# what a CPU run can read: no CUDA events, no graph replays
CPU_METRICS = ("engine.queue_ms", "batcher.first_chunk_ms",
               "batcher.first_chunk_ticks", "engine.pump_gap_ms",
               "batcher.useful_rows")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_store():
    TELEMETRY.clear()
    TELEMETRY.enabled = True
    yield
    TELEMETRY.enabled = True


@pytest.fixture(scope="module")
def dec():
    flow_cfg = dataclasses.replace(
        C.tiny_flow_config(), cfm=C.CFMConfig(n_timesteps=S,
                                              max_noise_len=2048))
    hift_cfg = C.tiny_hift_config()
    flow_state, hift_state = seeded_states(flow_cfg, hift_cfg)
    return AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        C.PipelineConfig(block_size=HOP, mel_cache_len=2,
                                         max_token_len=9), device="cpu")


def _engine(dec):
    return AB.AudioBatchEngine(dec, n_lanes=2, block_size=HOP,
                               ring_tokens=RING, token_cap=64,
                               pump_iters=PUMP_ITERS)


def _params(dec, n_requests=4):
    cfg = dec.flow_cfg
    rng = np.random.RandomState(7)
    return [{"tokens": rng.randint(0, cfg.vocab_size, (1, n)).tolist(),
             "embedding": rng.randn(1, cfg.spk_embed_dim).tolist()}
            for n in (9, 12, 7, 10)[:n_requests]]


def _serve(engine, params):
    """The requests concurrently through ``decode_stream``: per request
    (send time, first chunk received, body bytes, body rid)."""
    async def one(p):
        t_send = time.perf_counter()
        status, _, body = await AB.decode_stream(engine, p)
        assert status == 200
        parts, t_first = [], None
        async for data in body:
            t_first = t_first or time.perf_counter()
            parts.append(data)
        return t_send, t_first, b"".join(parts), body.rid

    async def run():
        return await asyncio.gather(*[one(p) for p in params])

    return asyncio.run(run())


# ------------------------------------------------------------------ store
def test_nested_spans_carry_parent_and_request_ids():
    st = LatencyStats()
    with st.span("outer", rid=7) as outer:
        with st.span("inner", rid=7) as inner:
            st.add("leaf", 1.0, 2.0, rid=7)
        st.call("call", lambda: None)
    st.add("alone", 3.0, 4.0)
    (o,), (i,), (leaf,), (c,), (a,) = (st.spans(n) for n in (
        "outer", "inner", "leaf", "call", "alone"))
    assert (o.id, i.id) == (outer.id, inner.id)
    assert o.parent is None and i.parent == o.id and c.parent == o.id
    assert leaf.parent == i.id and a.parent is None
    assert o.rid == i.rid == leaf.rid == 7 and c.rid is None
    assert o.t0 <= i.t0 <= i.t1 <= o.t1 and (leaf.t0, leaf.t1) == (1.0, 2.0)

    async def task(name):
        with st.span(name, annotated=False) as s:
            await asyncio.sleep(0.002)
            st.add(name + ".child", 0.0, 0.0)
        return s.id

    async def both():
        return await asyncio.gather(task("a"), task("b"))

    ids = asyncio.run(both())
    assert [st.spans(n + ".child")[0].parent for n in "ab"] == ids


def test_self_time_is_duration_less_child_coverage():
    st = LatencyStats()
    with st.span("p") as p:
        t0 = p.t0
        st.add("c", t0 + 0.001, t0 + 0.002)
        st.add("c", t0 + 0.0015, t0 + 0.003)      # overlaps the first
        st.add("c", t0 + 0.004, t0 + 100.0)       # past the parent's end
        time.sleep(0.006)
    span = st.spans("p")[0]
    assert len(st.children(span)) == 3
    assert st.self_s(span) == pytest.approx(0.002, abs=1e-9)
    assert st.self_s(st.spans("c")[0]) == pytest.approx(0.001, abs=1e-9)


def test_rings_stay_bounded():
    st = LatencyStats(span_capacity=4, request_capacity=3)
    for i in range(10):
        st.add("x", float(i), float(i) + 0.5)
        st.count("n", 2)
    assert [s.t0 for s in st.spans("x")] == [6.0, 7.0, 8.0, 9.0]
    assert st.counters["n"] == 20 and len(st.increments("n")) == 4
    rids = [st.request() for _ in range(5)]
    assert list(st.requests) == rids[2:]


def test_disabled_store_records_nothing():
    st = LatencyStats()
    st.enabled = False
    with st.span("x", device=torch.device("cpu")) as s:
        pass
    assert s is None and st.call("y", lambda: 5) == 5
    st.add("z", 0.0, 1.0)
    st.count("n")
    rid = st.request()
    st.stamp(rid, "open")
    assert rid is None and st.names() == [] and st.counters == {}
    assert not st.requests


def test_spans_annotate_only_while_a_profiler_records(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    st = LatencyStats()
    opened = []
    real = PR.annotate

    def watched(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(PR, "annotate", watched)
    with st.span("telemetry_quiet"):
        torch.zeros(2).add_(1)
    st.call("telemetry_quiet_call", lambda: torch.ones(2) * 2)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.span("telemetry_probe"):
            torch.zeros(2).add_(1)
        st.call("telemetry_probe_call", lambda: torch.ones(2) * 2)
        with st.span("telemetry_awaiting", annotated=False):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"telemetry_probe", "telemetry_probe_call"} <= names
    assert "telemetry_awaiting" not in names
    assert opened == ["telemetry_probe", "telemetry_probe_call"]
    assert len(st.spans("telemetry_probe_call")) == 1


def test_device_spans_on_the_cpu_have_no_device_time():
    st = LatencyStats()
    with st.span("x", device=torch.device("cpu")):
        pass
    st.resolve(wait=True)
    assert st.spans("x")[0].device_ms is None


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def served(dec):
    """Four requests over two lanes, the store fresh, with the number of
    the wavefront's per-row write flags set in each tick run."""
    TELEMETRY.clear()
    engine = _engine(dec)
    enabled = []
    inputs = kv_stream._lanes_inputs

    def counted(*a, **kw):
        out = inputs(*a, **kw)
        enabled.append(int(out[6].sum()))
        return out

    kv_stream._lanes_inputs = counted
    try:
        got = _serve(engine, _params(dec))
    finally:
        kv_stream._lanes_inputs = inputs
    store = types.SimpleNamespace(
        spans={n: TELEMETRY.spans(n) for n in TELEMETRY.names()},
        counters=dict(TELEMETRY.counters),
        requests=[dict(r) for r in TELEMETRY.requests.values()])
    return engine, got, enabled, store


def test_request_stamps_in_order(served):
    engine, got, _, store = served
    assert len(store.requests) == 4
    order = ("open", "admitted", "pushed", "finished", "first_chunk",
             "last_chunk")
    by_open = sorted(store.requests, key=lambda r: r["open"])
    for (t_send, t_first, _, _), rec in zip(sorted(got), by_open):
        stamps = [rec[k] for k in order]
        assert stamps == sorted(stamps), rec
        assert t_send <= rec["open"] and rec["first_chunk"] <= t_first
        assert rec["lane"] in (0, 1)
        assert rec["first_ticks"] >= S


def test_queue_and_first_chunk_sum_to_open_to_first_chunk(served):
    _, _, _, store = served
    for r in store.requests:
        queue = 1e3 * (r["finished"] - r["open"])
        first = 1e3 * (r["first_chunk"] - r["finished"])
        assert queue >= 0 and first >= 0
        assert abs(queue + first - 1e3 * (r["first_chunk"] - r["open"])) < 1
    # each push and finish: its lock wait a child, its own time the rest
    for name in ("engine.push", "engine.finish"):
        for span in store.spans[name]:
            waits = [w for w in store.spans["engine.lock_wait"]
                     if w.parent == span.id]
            assert len(waits) == 1 and waits[0].rid == span.rid
            assert span.t0 <= waits[0].t0 <= waits[0].t1 <= span.t1
    # each open: its lane wait and its admission, children of its request
    opens = {s.id: s for s in store.spans["engine.open"]}
    for name in ("engine.lane_wait", "engine.admit"):
        kids = store.spans[name]
        assert sorted(s.parent for s in kids) == sorted(opens)
        assert all(opens[s.parent].rid == s.rid for s in kids)


def test_pump_phases_lie_inside_their_pump(served):
    _, _, _, store = served
    pumps = {s.id: s for s in store.spans["batcher.pump"]}
    assert pumps
    assert sorted(s.parent for s in store.spans["batcher.encode"]) == \
        sorted(pumps)
    ran = sorted(s.parent for s in store.spans["batcher.wave"])
    assert ran and sorted(s.parent for s in store.spans["batcher.emit"]) \
        == ran and set(ran) <= set(pumps)
    for name in ("batcher.encode", "batcher.wave", "batcher.emit"):
        for s in store.spans[name]:
            p = pumps[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    emits = {s.id: s for s in store.spans["batcher.emit"]}
    fins = store.spans["batcher.finalize"]
    assert len(fins) == 4 and all(s.parent in emits for s in fins)
    gaps = store.spans["engine.pump_gap"]
    assert len(gaps) >= len(pumps) and all(g.t1 >= g.t0 for g in gaps)


def test_row_counters_match_the_wavefront(served):
    engine, _, enabled, store = served
    b = engine.batcher
    assert store.counters["batcher.ticks"] == b.ticks == len(enabled)
    assert store.counters["batcher.rows_computed"] == \
        S * 2 * b.lanes * b.ticks
    assert store.counters["batcher.rows_useful"] == sum(enabled)
    assert 0 < store.counters["batcher.rows_useful"] <= \
        store.counters["batcher.rows_computed"]


def test_audio_identical_with_the_store_off(dec, served):
    _, got, _, _ = served
    TELEMETRY.enabled = False
    off = _serve(_engine(dec), _params(dec))
    assert [g[2] for g in off] == [g[2] for g in got]
    assert all(g[3] is None for g in off) and TELEMETRY.names() == []


def test_encode_spans_belong_to_their_body(served):
    _, got, _, store = served
    rids = {g[3] for g in got}
    assert None not in rids and len(rids) == 4
    assert {s.rid for s in store.spans["engine.encode"]} == rids


def test_no_capture_after_boot(dec):
    engine = _engine(dec)
    boot_warmup_batcher(engine.batcher, pump_iters=PUMP_ITERS,
                        verbose=False)
    after_boot = dict(engine.batcher._steps.captures)
    assert after_boot and all(n == 1 for n in after_boot.values())
    _serve(engine, _params(dec, 2))
    assert dict(engine.batcher._steps.captures) == after_boot
    cold = _engine(dec)
    _serve(cold, _params(dec, 2))
    assert cold.batcher._steps.captures
    assert set(cold.batcher._steps.captures) <= set(after_boot)


# -------------------------------------------------------------- benchmark
def _tiny_cell():
    from port_bench.tests.tiny import tiny_cells, with_reference
    return with_reference(tiny_cells()[0], "moss_decoder_24k")


def test_traced_bench_run_reads_the_program_metrics():
    from port_bench import run
    cell = _tiny_cell()
    assert set(NEW_METRICS) <= {m["name"] for m in cell.per_layer}
    out = run.run_cell(cell, 2**31 + 11, 2.0, True, "cpu",
                       t_start=time.perf_counter())
    assert out["correct"] is True
    got = out["metrics"]
    assert set(CPU_METRICS) <= set(got)
    assert not (set(NEW_METRICS) - set(CPU_METRICS)) & set(got)
    assert got["batcher.first_chunk_ticks"]["value"] >= \
        cell.config["flow"]["cfm"]["n_timesteps"]
    assert 0 < got["batcher.useful_rows"]["value"] <= 100
    assert got["engine.queue_ms"]["unit"] == "ms"


def test_readers_without_the_store_read_nothing(monkeypatch):
    from port_bench.harness import spec, telemetry
    monkeypatch.setattr(telemetry, "store", lambda: None)
    run = types.SimpleNamespace(t0=0.0, t1=float("inf"), slice=None,
                                trace=None, counters={}, spans=None)
    for name in NEW_METRICS:
        mod = spec.load_module(spec.ROOT / "metrics" / f"{name}.py", name)
        assert mod.read(run) is None, name


def test_device_phase_readers_per_tick(monkeypatch):
    """The device-time readers' arithmetic over a store whose spans carry
    device times (a CUDA run's): each phase of the window's pumps per
    tick, the emit phase less its finalize tails."""
    from port_bench.harness import spec, telemetry
    st = LatencyStats()
    ms = {"batcher.encode": 3.0, "batcher.wave": 20.0, "batcher.emit": 9.0,
          "batcher.finalize": 4.0}
    for _ in range(2):
        with st.span("batcher.pump"):
            st.count("batcher.ticks", 4)
            for name in ("batcher.encode", "batcher.wave", "batcher.emit"):
                with st.span(name) as s:
                    st._device_ms[s.id] = ms[name]
                    if name == "batcher.emit":
                        with st.span("batcher.finalize") as f:
                            st._device_ms[f.id] = ms["batcher.finalize"]
                        st.call("graphs.voc", lambda: time.sleep(0.001))
    monkeypatch.setattr(telemetry, "store", lambda: st)
    run = types.SimpleNamespace(t0=0.0, t1=float("inf"), slice=None)

    def read(name):
        return spec.load_module(spec.ROOT / "metrics" / f"{name}.py",
                                name).read(run)

    assert read("batcher.enc_ms") == pytest.approx(2 * 3.0 / 8)
    assert read("batcher.wave_ms") == pytest.approx(2 * 20.0 / 8)
    assert read("batcher.voc_ms") == pytest.approx(2 * (9.0 - 4.0) / 8)
    assert read("batcher.finalize_ms") == pytest.approx(2 * 4.0 / 8)
    launch = sum(s.duration_s for s in st.spans("graphs.voc"))
    assert read("graphs.launch_ms") == pytest.approx(1e3 * launch / 8)
    # a pump overlapping the traced slice is left out, with its ticks
    first = st.spans("batcher.pump")[0]
    run.slice = (first.t0, first.t1)
    assert read("batcher.wave_ms") == pytest.approx(20.0 / 4)
