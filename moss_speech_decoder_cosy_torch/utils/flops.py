"""FLOP accounting and MFU (model FLOPs utilization), after the JAX
package's ``utils/flops.py``.

The JAX package reads XLA's cost analysis of its compiled programs.  The
port counts the FLOPs of the steps it runs: ``FlopCounterMode`` over one
eager run of each step, times the step's dispatches (``DispatchMeter``).
It counts the matrix products and convolutions (2 per multiply-add);
element-wise work counts nothing.

The hand-written kernels launch through ``ctypes``, which the counter does
not see, and on the CPU their plain versions run instead.  Each kernel
entry therefore reports its analytic count, the JAX package's
``pl.CostEstimate`` formula for the same kernel, through ``kernel_flops``,
which also keeps its plain body's products out of the tally: one session
counts the same FLOPs on the CPU and on the card.

Peaks are NVIDIA's H100 SXM data-sheet figures: dense bf16 on the tensor
cores, and f32 on the CUDA cores (TF32 off).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores,
# HBM3 bytes per second
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

_ACTIVE: List["FlopTally"] = []


class FlopTally:
    """Counts the FLOPs of what runs inside it: the PyTorch products seen by
    ``FlopCounterMode``, less those of a kernel's plain version, plus each
    kernel's analytic count (``kernel_flops``)."""

    def __init__(self):
        self._mode = FlopCounterMode(display=False)
        self._plain = 0
        self.kernels = 0

    def __enter__(self) -> "FlopTally":
        self._mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
        self._mode.__exit__(*exc)

    @property
    def total(self) -> int:
        return self._mode.get_total_flops() - self._plain + self.kernels


@contextlib.contextmanager
def kernel_flops(n: int):
    """Wraps a hand-written kernel's entry: inside an active tally the
    kernel counts its analytic ``n`` FLOPs, and the products of whatever
    runs inside (the plain version on the CPU) count nothing."""
    tally = _ACTIVE[-1] if _ACTIVE else None
    if tally is None:
        yield
        return
    before = tally._mode.get_total_flops()
    yield
    tally._plain += tally._mode.get_total_flops() - before
    tally.kernels += int(n)


def count_flops(fn: Callable[[], object]):
    """(fn(), the FLOPs it ran)."""
    with FlopTally() as tally:
        out = fn()
    return out, tally.total


def fused_tf_group_flops(rows: int, cf: int, cin: int, ch: int, inner: int,
                         n_layers: int, rp: int) -> int:
    """The FLOPs of one ``fused_tf_group`` launch as the JAX package's cost
    estimate counts them (``ops/pallas_block.py``): the resnet prologue (two
    conv3, the 1x1 residual, the time MLP) and L blocks (QKV, out-proj, FF
    and the attention, the last at twice the product's FLOPs for the TPU
    kernel's block-diagonal pairing)."""
    return (2 * rows * cf * (3 * cin * ch + 3 * ch * ch + cin * ch)
            + 2 * rows * 4 * ch * ch
            + n_layers * 2 * rows * cf * (3 * ch * inner + inner * ch
                                          + 8 * ch * ch)
            + n_layers * 8 * rows * rp * cf * inner)


def fused_conformer_group_flops(n_layers: int, cf: int, d: int,
                                rt: int) -> int:
    """The FLOPs of one ``fused_conformer_group`` launch as the JAX
    package's cost estimate counts them (``ops/pallas_conformer.py``): per
    layer the QKV, position, out-proj and FF products, the attention over
    [ring ++ chunk] (content, position and value terms) and the one-hot
    ring write of K, V and the position term."""
    return n_layers * (2 * cf * d * (3 * d + d + d + 4 * d + 4 * d)
                       + 2 * 3 * cf * (rt + cf) * d
                       + 2 * rt * cf * (3 * d))


class DispatchMeter:
    """Counts the steps a session dispatches while ``enabled``: per key, the
    dispatches and the FLOPs of the first one, run eagerly inside a
    ``FlopTally`` (a step's FLOPs depend on its shapes, which its key
    fixes).  ``total_flops()`` is the sum over keys of dispatches x FLOPs.
    A session routes its graphed steps (``StepGraphs``) and its eager calls
    (``call``) through its meter."""

    def __init__(self):
        self.enabled = False
        self._records: Dict[Hashable, List[int]] = {}  # key -> [n, flops]

    def reset(self) -> None:
        self._records.clear()

    def note(self, key: Hashable, fn: Callable[[], object]):
        """Counts one dispatch of ``key``.  Returns (True, fn()) when this
        call ran ``fn`` (the key's first, run inside a tally), else
        (False, None): the caller runs the step as it would."""
        rec = self._records.get(key)
        if rec is not None:
            rec[0] += 1
            return False, None
        out, flops = count_flops(fn)
        self._records[key] = [1, flops]
        return True, out

    def call(self, key: Hashable, fn: Callable[[], object]):
        """Runs the eager call ``fn``, counted under ``key`` when enabled."""
        if not self.enabled:
            return fn()
        ran, out = self.note(key, fn)
        return out if ran else fn()

    def total_flops(self) -> float:
        return float(sum(n * f for n, f in self._records.values()))

    def dispatches(self) -> int:
        return sum(n for n, _ in self._records.values())


def chip_peak_flops(device=None, dtype=torch.bfloat16) -> Optional[float]:
    """Peak FLOP/s of one card for ``dtype`` (bf16 or f32): an H100's
    data-sheet figure; None on the CPU or another card."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(
            device):
        return None
    return PEAK_FLOPS[str(dtype).split(".")[-1]]


def mfu(total_flops: float, seconds: float, device=None,
        dtype=torch.bfloat16) -> Optional[float]:
    """Delivered FLOP/s over the card's peak; None where the peak is
    unknown (the CPU)."""
    peak = chip_peak_flops(device, dtype)
    if peak is None or seconds <= 0:
        return None
    return total_flops / seconds / peak
