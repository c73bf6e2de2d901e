"""The fixture's family: a speech LM whose program serves, for each request,
the speech head's logits over [sos, prompt, task, speech tokens], one row
for each position from the task id on (n_tokens + 1 rows).

- ``lm_config``: the port's ``SpeechLMConfig`` of the configuration file;
- ``states``: the ``Qwen2SpeechLM`` state dict, float32, seeded
  (``weights.seeded_state``), which the driver loads;
- ``reference_output``: the plain reference's ``logits(config, state,
  prompt, tokens, device, precision)``;
- ``compare``: the readings ``logit_gap``, ||served - reference|| /
  ||reference|| over all the sampled rows (a request weighs by its length),
  and ``length_gap``, the largest difference in rows; and each pair's
  ``logit_gap``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.harness import weights


def lm_config(config: Dict):
    from moss_speech_decoder_cosy_torch.models.llm.qwen2 import Qwen2Config
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        SpeechLMConfig)
    return SpeechLMConfig(backbone=Qwen2Config(**config["backbone"]),
                          speech_token_size=config["speech_token_size"])


def states(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM)
    with torch.device("meta"):
        model = Qwen2SpeechLM(lm_config(cell.config))
    return weights.seeded_state(model, weights.seed_for(seed, 0), device)


def reference_output(cell, record, states, device,
                     precision: str = "float32") -> np.ndarray:
    return cell.reference().logits(cell.config, states, record.prompt,
                                   record.tokens, device, precision=precision)


def _gap(served: np.ndarray, ref: np.ndarray) -> float:
    if served.shape != ref.shape:
        return math.inf
    den = float(np.linalg.norm(ref))
    return float(np.linalg.norm(served - ref)) / max(den, 1e-12)


def compare(cell, pairs) -> Tuple[Dict[str, float], List[List[float]]]:
    each = [[_gap(s, r)] for s, r in pairs]
    if not pairs:
        return {"logit_gap": math.inf, "length_gap": math.inf}, each
    if any(s.shape != r.shape for s, r in pairs):
        gap = math.inf
    else:
        gap = _gap(np.concatenate([s for s, _ in pairs]),
                   np.concatenate([r for _, r in pairs]))
    return {"logit_gap": gap,
            "length_gap": max(abs(len(s) - len(r)) for s, r in pairs)}, each
