"""Entry driver: offline synthesis through ``V1Decoder.token2wav``.

One ``V1Decoder`` built from the configuration (its weights drawn on the
card from the seed) serves each client's requests one at a time: a call
takes the request's tokens and x-vector and returns the whole waveform on
the host, so the first audio and the last arrive together.  Set-up warms
the decoder with one call at the traffic's shortest and one at its longest
length (cuBLAS and cuDNN pick their kernels, the allocator grows its pools).

In a traced run the profiler covers ``trace_requests`` whole requests from
``trace_at`` of the window on.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List

import numpy as np

from port_bench.harness import configs, weights
from port_bench.harness.traffic import Traffic
from port_bench.harness.trace import DeviceTrace
from port_bench.harness.window import Record, RunResult, Served



class Driver:
    def __init__(self, cell, seed: int, device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.sample_rate = int(cell.config["hift"]["sampling_rate"])
        if int(cell.traffic["clients"]) != 1:
            raise ValueError("the token2wav driver runs one client")
        self.traffic = Traffic(cell.traffic, seed)
        self.dec = None
        self._served: Dict[int, Served] = {}
        self.setup_parts: Dict[str, float] = {}

    def setup(self) -> None:
        import torch
        from moss_speech_decoder_cosy_torch.model_dir import V1Decoder
        cfg = self.cell.config
        prec = cfg["precision"]
        torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(prec["tf32"])
        t = time.perf_counter()
        flow_cfg, hift_cfg = configs.flow_hift(cfg)
        fs, hs = weights.model_states(cfg, self.seed, self.device)
        self.dec = V1Decoder(flow_cfg, hift_cfg, fs, hs,
                             mel_hop=cfg["pipeline"]["mel_hop"],
                             compute_dtype=configs.torch_dtype(
                                 prec["compute_dtype"]),
                             device=self.device)
        del fs, hs
        self.setup_parts["build"] = time.perf_counter() - t
        t = time.perf_counter()
        spk = np.zeros((1, cfg["flow"]["spk_embed_dim"]), np.float32)
        for n in (self.cell.traffic["tokens"]["min"],
                  self.cell.traffic["tokens"]["max"]):
            self.dec.token2wav(np.zeros((1, n), np.int32), embedding=spk)
        self.setup_parts["warm_calls"] = time.perf_counter() - t

    def run(self, seconds: float) -> RunResult:
        records: List[Record] = []
        counter = itertools.count()
        trace = self.trace and self.device.type == "cuda"
        opts = self.cell.cell.get("trace", {})
        dtrace, traced, sl = None, [], None
        t0 = time.perf_counter()
        t1 = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= t1:
                break
            if trace and dtrace is None and now >= t0 + opts["trace_at"] * seconds:
                dtrace = DeviceTrace()
                dtrace.start()
                ts = time.perf_counter()
            req = self.traffic.get(next(counter))
            rec = Record(req.index, req.n_tokens,
                         self.dec.mel_len(req.n_tokens) * self.dec.mel_hop
                         / self.sample_rate, time.perf_counter())
            records.append(rec)
            try:
                wav = self.dec.token2wav(req.tokens[None],
                                         embedding=req.speaker[None])[0]
            except Exception as e:      # a failed request is counted
                rec.error = repr(e)
                continue
            rec.t_first = rec.t_last = time.perf_counter()
            rec.chunks.append((rec.t_last, wav.shape[0]))
            self._served[req.index] = Served(req.tokens, req.speaker, wav)
            if dtrace is not None and sl is None:
                traced.append(req.n_tokens)
                if len(traced) >= opts["trace_requests"]:
                    te = time.perf_counter()
                    dtrace.stop()
                    sl = (ts, te)
        res = RunResult(self.cell, records, t0, t1, self.sample_rate,
                        counters={"traced_requests": traced},
                        t_done=time.perf_counter())
        if dtrace is not None:
            if sl is None:
                te = time.perf_counter()
                dtrace.stop()
                sl = (ts, te)
            res.trace, res.slice = dtrace.result(), sl
        return res

    def served(self) -> Dict[int, Served]:
        return dict(self._served)

    def close(self) -> None:
        self.dec = None
