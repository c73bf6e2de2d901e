"""A configuration file -> the port's config dataclasses (the program's side;
the reference reads the same file as plain JSON)."""

from __future__ import annotations

from typing import Dict, Tuple


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _make(cls, d: Dict):
    return cls(**{k: _tuples(v) for k, v in d.items()})


def flow_hift(cfg: Dict) -> Tuple[object, object]:
    """(FlowConfig, HiFTConfig) of a configuration file."""
    from moss_speech_decoder_cosy_torch.utils import config as C
    fl = dict(cfg["flow"])
    flow = _make(C.FlowConfig, dict(
        fl, encoder=_make(C.EncoderConfig, fl["encoder"]),
        estimator=_make(C.EstimatorConfig, fl["estimator"]),
        cfm=_make(C.CFMConfig, fl["cfm"])))
    return flow, _make(C.HiFTConfig, cfg["hift"])


def pipeline(cfg: Dict):
    from moss_speech_decoder_cosy_torch.utils import config as C
    p = cfg["pipeline"]
    return C.PipelineConfig(**{k: p[k] for k in (
        "block_size", "mel_cache_len", "max_token_len", "sample_rate",
        "token_overlap_len")})


def torch_dtype(name):
    import torch
    return None if name in (None, "float32") else getattr(torch, name)
