"""What the measurement tools share (``profile_wave``, ``profile_tail``,
``analyze_wave_copies``, ``ablate_dtype``, ``ablate_block``): the decoder
``bench.py`` runs, with seeded weights, at full width (``--config moss``)
or at the tests' tiny width (``--config tiny``), on ``--device``."""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..utils import config as C

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def configs(name: str):
    """(flow_cfg, hift_cfg): the MOSS presets with ``bench.py``'s
    4096-frame noise buffer, or the tiny ones."""
    if name == "tiny":
        return C.tiny_flow_config(), C.tiny_hift_config()
    flow = C.moss_flow_config()
    flow = dataclasses.replace(flow, cfm=dataclasses.replace(
        flow.cfm, max_noise_len=4096))
    return flow, C.moss_hift_config()


def bench_pipe() -> C.PipelineConfig:
    return C.PipelineConfig(block_size=5, mel_cache_len=8, max_token_len=40)


def seeded_decoder(config: str, device, dtype=torch.bfloat16, pipe=None,
                   flow_cfg=None, states=None, **kw):
    """An ``AudioDecoder`` of ``config`` with weights from seeds 0 / 1 (or
    ``states``), ``dtype`` compute, ``bench.py``'s pipeline geometry."""
    from ..pipeline import AudioDecoder
    from ..weights import seeded_states
    fcfg, hcfg = configs(config)
    fcfg = flow_cfg or fcfg
    states = states or seeded_states(fcfg, hcfg)
    return AudioDecoder(fcfg, hcfg, *states, pipe or bench_pipe(),
                        compute_dtype=dtype, device=device, **kw)


def common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--config", choices=["moss", "tiny"], default="moss")
    p.add_argument("--device", default="cuda")
    return p


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def wall(dev, fn):
    """(seconds, result) of ``fn()`` between two device fences."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return time.perf_counter() - t0, out
