"""The decoder family: a configuration with a flow and a HiFT vocoder (its
``flow`` and ``hift`` keys), whose program serves waveforms.  The check's
model-specific steps for such a cell:

- ``states``: the flow's and the vocoder's seeded float32 state dicts
  (``weights.model_states``), the tensors the drivers load;
- ``reference_output``: one request's waveform by the configuration's plain
  reference (``decode(config, flow, hift, tokens, speaker, device,
  precision)``), read back as pcm16 where the cell's check says the program
  serves pcm16;
- ``compare``: ``check.compare`` and ``check.per_request`` of (served,
  reference) pairs at the vocoder's sampling rate and mel-frame hop.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from port_bench.harness import check, weights


def states(cell, seed: int, device) -> Tuple[Dict, Dict]:
    return weights.model_states(cell.config, seed, device)


def reference_output(cell, record, states, device,
                     precision: str = "float32") -> np.ndarray:
    flow, hift = states
    wav = cell.reference().decode(cell.config, flow, hift, record.tokens,
                                  record.speaker, device, precision=precision)
    return check.pcm16(wav) if cell.cell["check"].get("pcm16", False) else wav


def compare(cell, pairs) -> Tuple[Dict[str, float], List[List[float]]]:
    sr, hop = cell.config["hift"]["sampling_rate"], check.frame_hop(
        cell.config)
    return check.compare(pairs, sr, hop), check.per_request(pairs, sr, hop)
