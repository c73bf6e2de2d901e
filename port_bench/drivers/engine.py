"""Entry driver: the decode server's request core.

Requests go through ``serving.audio_batcher.decode_stream(engine, params)``
with the JSON-shaped parameters the HTTP shell passes (``tokens``,
``embedding``, ``format: pcm16``), over one ``AudioBatchEngine`` built from
the configuration and the cell's ``engine`` options and warmed in set-up by
``serving.boot.boot_warmup_batcher`` (every CUDA graph captured, the
finalize tails among them) and one request through the core.  Clients run a
closed loop with no think time: each sends its next request when the last
one's body has ended.  A client holds a chunk when the body yields it.

In a traced run the driver times each ``AudioBatchEngine.open`` and each
``KVContinuousBatcher.pump`` (wrappers on the two objects, around the
program's own calls), records the lanes' host state before each pump (the
wavefront geometry of its ticks, for the kernel's roofline) and puts a slice
of the window under the profiler, started and stopped between pumps under
the engine's lock.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import Dict, List, Optional

import numpy as np

from port_bench.harness import configs, weights
from port_bench.harness.traffic import Request, Traffic
from port_bench.harness.trace import DeviceTrace, Spans
from port_bench.harness.window import Record, RunResult, Served

DRAIN_S = 60.0                  # how long requests sent in the window may take



class Driver:
    def __init__(self, cell, seed: int, device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        cfg = cell.config
        self.sample_rate = int(cfg["hift"]["sampling_rate"])
        self.samples_per_token = (cfg["flow"]["token_mel_ratio"] * int(
            np.prod(cfg["hift"]["upsample_rates"]))
            * cfg["hift"]["istft_hop_len"])
        self.traffic = Traffic(cell.traffic, seed)
        self.opts = cell.cell["engine"]
        self.engine = None
        self._bodies: Dict[int, bytes] = {}
        self._reqs: Dict[int, Request] = {}
        self.spans = Spans()
        self.pumps: List[dict] = []
        self._tracing = False
        self.setup_parts: Dict[str, float] = {}

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        import torch
        from moss_speech_decoder_cosy_torch.pipeline.audio_decoder import (
            AudioDecoder)
        from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
            AudioBatchEngine)
        from moss_speech_decoder_cosy_torch.serving.boot import (
            boot_warmup_batcher)
        cfg = self.cell.config
        prec, srv = cfg["precision"], cfg["serving"]
        torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(prec["tf32"])
        t = time.perf_counter()
        flow_cfg, hift_cfg = configs.flow_hift(cfg)
        fs, hs = weights.model_states(cfg, self.seed, self.device)
        dec = AudioDecoder(
            flow_cfg, hift_cfg, fs, hs, pipe_cfg=configs.pipeline(cfg),
            compute_dtype=configs.torch_dtype(prec["compute_dtype"]),
            estimator_dtype=configs.torch_dtype(prec.get("estimator_dtype")),
            device=self.device)
        del fs, hs
        self.engine = AudioBatchEngine(
            dec, n_lanes=self.opts["n_lanes"], ring_tokens=srv["ring_tokens"],
            token_cap=srv["token_cap"], pump_iters=self.opts["pump_iters"])
        b = self.engine.batcher
        if self.device.type == "cuda" and (
                b._kernel != (srv["engine"] == "kernel")
                or b._graphs != srv["graphs"]):
            raise RuntimeError(f"the batcher runs kernel={b._kernel} "
                               f"graphs={b._graphs}, not the configuration's")
        self.setup_parts["build"] = time.perf_counter() - t
        self.setup_parts["boot_warmup"] = boot_warmup_batcher(
            b, pump_iters=self.opts["pump_iters"], verbose=False)
        if self.trace:
            self._instrument()

    def _instrument(self) -> None:
        eng, b = self.engine, self.engine.batcher
        open_, pump = eng.open, b.pump

        async def open_timed(*a, **kw):
            t = time.perf_counter()
            stream = await open_(*a, **kw)
            self.spans.items["engine.open"].append((t, time.perf_counter()))
            return stream

        def pump_timed(max_iters: int = 8):
            before = [(getattr(st, "w_host", 0), st.active)
                      for st in b._lanes]
            ticks = b.ticks
            t = time.perf_counter()
            out = pump(max_iters=max_iters)
            self.pumps.append(dict(
                t=t, t_end=time.perf_counter(), ticks=b.ticks - ticks,
                traced=self._tracing, lanes=self._lane_states(before)))
            return out

        eng.open = open_timed
        b.pump = pump_timed

    def _lane_states(self, before) -> List[tuple]:
        """Each lane's (w, avail, k_total, base frames) in the pump just
        run, from the batcher's host mirror: a lane that was not live keeps
        its w and advances nothing."""
        b = self.engine.batcher
        out = []
        for (w0, was_active), st in zip(before, b._lanes):
            if not (was_active and getattr(st, "prefilled", False)):
                out.append((w0, 0, 1 << 30, 0))
            elif st.finished:
                out.append((w0, st.k_total + b.s_steps - 1, st.k_total,
                            st.prompt_len * b.ratio))
            else:
                out.append((w0, st.chunks_encoded, 1 << 30,
                            st.prompt_len * b.ratio))
        return out

    # ------------------------------------------------------------ window
    async def _request(self, req: Request, rec: Optional[Record]) -> None:
        from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
            decode_stream)
        params = {"tokens": [req.tokens.tolist()],
                  "embedding": [req.speaker.tolist()], "format": "pcm16"}
        parts = []
        try:
            status, _, body = await decode_stream(self.engine, params)
            if status != 200:
                raise RuntimeError(f"status {status}")
            async for data in body:
                t = time.perf_counter()
                if rec is not None:
                    rec.chunks.append((t, len(data) // 2))
                    if rec.t_first is None:
                        rec.t_first = t
                parts.append(data)
        except Exception as e:          # a failed request is counted, not fatal
            if rec is not None:
                rec.error = repr(e)
            return
        if rec is None:
            return
        body = b"".join(parts)
        if len(body) // 2 != req.n_tokens * self.samples_per_token:
            rec.error = f"body of {len(body) // 2} samples"
            return
        rec.t_last = time.perf_counter()
        self._bodies[req.index] = body
        self._reqs[req.index] = req

    async def _window(self, seconds: float) -> RunResult:
        n_warm = self.cell.traffic["tokens"]["min"]
        t = time.perf_counter()
        await self._request(Request(-1, np.zeros(n_warm, np.int32), np.zeros(
            self.cell.traffic["speaker_dim"], np.float32)), None)
        self.setup_parts["warm_request"] = time.perf_counter() - t
        records: List[Record] = []
        counter = itertools.count()
        t0 = time.perf_counter()
        t1 = t0 + seconds

        async def client():
            while time.perf_counter() < t1:
                req = self.traffic.get(next(counter))
                rec = Record(req.index, req.n_tokens,
                             req.n_tokens * self.samples_per_token
                             / self.sample_rate, time.perf_counter())
                records.append(rec)
                await self._request(req, rec)

        tasks = [asyncio.ensure_future(client())
                 for _ in range(int(self.cell.traffic["clients"]))]
        tracer = None
        if self.trace and self.device.type == "cuda":
            tracer = asyncio.ensure_future(self._traced_slice(t0, seconds))
        _, pending = await asyncio.wait(tasks, timeout=seconds + DRAIN_S)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        res = RunResult(self.cell, records, t0, t1, self.sample_rate,
                        spans=self.spans, counters={"pumps": self.pumps},
                        t_done=time.perf_counter())
        if tracer is not None:
            await tracer
            res.trace, res.slice = self._dtrace.result(), self._slice
        return res

    async def _traced_slice(self, t0: float, seconds: float) -> None:
        """The profiler over ``trace_s`` seconds from ``trace_at`` of the
        window, started and stopped between pumps."""
        opts = self.cell.cell["trace"]
        lock = self.engine._lock
        await asyncio.sleep(max(0.0, t0 + opts["trace_at"] * seconds
                                - time.perf_counter()))
        self._dtrace = DeviceTrace()
        async with lock:
            self._dtrace.start()
            self._tracing = True
            ts = time.perf_counter()
        await asyncio.sleep(opts["trace_s"])
        async with lock:
            self._tracing = False
            te = time.perf_counter()
            self._dtrace.stop()
        self._slice = (ts, te)

    def run(self, seconds: float) -> RunResult:
        return asyncio.run(self._window(seconds))

    # ------------------------------------------------------------ after
    def served(self) -> Dict[int, Served]:
        return {i: Served(self._reqs[i].tokens, self._reqs[i].speaker,
                          np.frombuffer(body, "<i2").astype(np.float32)
                          / 32767.0)
                for i, body in self._bodies.items()}

    def close(self) -> None:
        self.engine = None
