"""bf16 serving-quality ablation, after the JAX package's
``bin/ablate_dtype.py``: which f32 islands does the flow stack need?

    python -m moss_speech_decoder_cosy_torch.bin.ablate_dtype \
        [--tokens 250] [--config moss|tiny] [--device cuda|cpu]

The same offline flow decode (250 tokens, ~20 s of audio, the
``moss_flow_config()`` flow with ``bench.py``'s noise buffer, weights from
seed 0) under one dtype recipe each:

- ``f32``: the reference;
- ``bf16_old``: everything bf16, the ODE carry in bf16
  (``solver_dtype="compute"``);
- ``bf16_f32ode``: everything bf16, the Euler carry, CFG combine and t
  schedule in f32 (the default ``solver_dtype="float32"``);
- ``bf16_est``: encoder f32, estimator bf16 (``AudioDecoder(compute_dtype=
  float32, estimator_dtype=bfloat16)``, the estimator's input cast at the
  boundary);
- ``bf16_enc``: encoder bf16, estimator f32.

``bf16_est`` against ``bf16_enc`` attributes the error to the estimator or
to the quantized mu; ``bf16_old`` against ``bf16_f32ode`` isolates the
solver's accumulation.  Prints the JAX tool's JSON: ``mean_abs_golden``
and, per recipe, ``mel_mae`` and ``rel`` (mae / mean |golden|).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from .tool_setup import common_args, configs, seeded_decoder


def parse_args(argv=None):
    p = common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--tokens", type=int, default=250)
    return p.parse_args(argv)


# recipe -> (solver_dtype, compute_dtype, estimator_dtype)
RECIPES = {
    "bf16_old": ("compute", torch.bfloat16, None),
    "bf16_f32ode": ("float32", torch.bfloat16, None),
    "bf16_est": ("float32", torch.float32, torch.bfloat16),
    "bf16_enc": ("float32", torch.bfloat16, torch.float32),
}


def main(argv=None, states=None):
    """``states``: (flow, hift) state dicts of ``--config``'s modules in
    place of the seeded ones (a caller that holds them already)."""
    args = parse_args(argv)
    from ..utils.device import resolve_device
    from ..weights import seeded_states
    dev = resolve_device(args.device)
    flow_cfg, hift_cfg = configs(args.config)
    states = states or seeded_states(flow_cfg, hift_cfg)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, args.tokens))
    emb = rng.standard_normal((1, flow_cfg.spk_embed_dim)).astype(
        np.float32)
    prompt_tok = np.zeros((1, 0), np.int32)
    prompt_feat = np.zeros((1, 0, flow_cfg.output_size), np.float32)

    def offline(solver, compute, estimator):
        cfg = dataclasses.replace(flow_cfg, cfm=dataclasses.replace(
            flow_cfg.cfm, solver_dtype=solver))
        dec = seeded_decoder(args.config, dev, compute, flow_cfg=cfg,
                             states=states, estimator_dtype=estimator)
        return dec._flow_mel(tokens, prompt_tok, prompt_feat, emb,
                             streaming=False, finalize=True)

    print("# golden f32...", file=sys.stderr, flush=True)
    golden = offline("float32", torch.float32, None)
    scale = float(np.mean(np.abs(golden)))
    out = {"mean_abs_golden": scale}
    for name, recipe in RECIPES.items():
        print(f"# {name}...", file=sys.stderr, flush=True)
        mae = float(np.mean(np.abs(offline(*recipe) - golden)))
        out[name] = {"mel_mae": mae, "rel": mae / scale}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
