"""Tiny cells for the CPU tests: the port's ``tiny_*`` presets through the
same drivers, traffic, readers and references as the benchmark's cells."""

from __future__ import annotations

import copy
import dataclasses
import json

from port_bench.harness import spec


def _dd(x):
    return json.loads(json.dumps(dataclasses.asdict(x)))


def tiny_configs():
    from moss_speech_decoder_cosy_torch.utils import config as C
    moss = {"name": "moss_tiny", "reduced": [],
            "flow": _dd(C.tiny_flow_config()), "hift": _dd(C.tiny_hift_config()),
            "pipeline": {"block_size": 3, "mel_cache_len": 8,
                         "max_token_len": 9, "sample_rate": 24000,
                         "token_overlap_len": 3.5},
            "serving": {"ring_tokens": 6, "engine": "kernel", "graphs": True,
                        "token_cap": 64},
            "precision": {"compute_dtype": "float32", "estimator_dtype": None,
                          "tf32": False}}
    v1_flow = dataclasses.replace(
        C.tiny_flow_config(), input_frame_rate=50, token_mel_ratio=2,
        encoder=dataclasses.replace(C.tiny_flow_config().encoder,
                                    pos_enc_layer_type="rel_pos_espnet"),
        estimator=dataclasses.replace(C.tiny_flow_config().estimator,
                                      channels=(24, 24), causal=False))
    hift1 = dataclasses.replace(C.tiny_hift_config(), sampling_rate=22050)
    v1 = {"name": "v1_tiny", "reduced": [], "flow": _dd(v1_flow),
          "hift": _dd(hift1),
          "pipeline": {"mel_hop": 256, "sample_rate": 22050},
          "precision": {"compute_dtype": "float32", "tf32": False}}
    return moss, v1


def tiny_cells():
    """(moss cell, v1 cell) as ``spec.Cell`` objects."""
    moss_cfg, v1_cfg = tiny_configs()
    bench = spec.benchmark()
    e2e = bench["end_to_end"]

    def layer(name):
        return [m for m in bench["per_layer"]
                if name in m.get("workloads", [name])]

    moss = spec.Cell(
        "moss_serve16", {"name": "moss_serve16", "config": "moss_tiny",
                         "traffic": "t", "chips": 1},
        moss_cfg,
        {"config": "moss_tiny", "traffic": "t", "driver": "engine",
         "engine": {"n_lanes": 2, "pump_iters": 4}, "flops": "stream",
         "trace": {"trace_at": 0.4, "trace_s": 0.5},
         "check": {"sample": 2, "pcm16": True,
                   "limits": {"wav_gap": 0.23, "length_gap": 0}}},
        {"clients": 2, "tokens": {
            "dist": "lognormal", "median": 12, "sigma": 0.3, "min": 8,
            "max": 20, "strata": 16}, "vocab": 64, "speaker_dim": 12},
        e2e, layer("moss_serve16"))
    v1 = spec.Cell(
        "cosyvoice1_offline_long",
        {"name": "cosyvoice1_offline_long", "config": "v1_tiny",
         "traffic": "t", "chips": 1},
        v1_cfg,
        {"config": "v1_tiny", "traffic": "t", "driver": "token2wav",
         "flops": "offline_v1", "trace": {"trace_at": 0.4, "trace_requests": 1},
         "check": {"sample": 2, "limits": {"wav_gap": 1e-4,
                                           "length_gap": 0}}},
        {"clients": 1, "tokens": {
            "dist": "uniform", "min": 30, "max": 50, "strata": 8},
         "vocab": 64, "speaker_dim": 12},
        e2e, layer("cosyvoice1_offline_long"))
    return moss, v1


def with_reference(cell, name):
    """``cell`` whose reference module is the benchmark's ``name``."""
    c = copy.copy(cell)
    c.entry = dict(cell.entry, config=name)
    return c
