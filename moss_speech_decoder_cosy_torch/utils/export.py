"""Export and ahead-of-time dispatch, after the JAX package's
``utils/export.py`` (the reference's export_jit / export_onnx / TensorRT
build, cosyvoice/bin/export_jit.py, export_onnx.py), and checkpoint
averaging (bin/average_model.py).

- ``aot_compile``: JAX's role kept, compile once for fixed shapes and then
  dispatch forever.  On a card ``fn`` is captured as one CUDA graph for the
  example shapes (``utils/graphs.StepGraphs``, the sessions' machinery);
  the returned callable copies its arguments into the graph's static
  buffers and replays it.  Not AOTInductor: that generates its own kernels
  in place of the hand-written ones.  Raises off a card.
- ``export_serialized`` / ``load_serialized``: portable bytes through
  ``torch.export`` (``torch.export.save`` / ``load`` on an in-memory
  buffer), deployable without the model's Python code.
- ``average_checkpoints``: the uniform mean of checkpoints.
"""

from __future__ import annotations

import io
from typing import Callable, Mapping, Sequence

import torch
from torch import nn


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def aot_compile(fn: Callable, *example_args) -> Callable:
    """``fn`` (tensors -> a tensor or a tree of them, no host reads)
    captured as a CUDA graph for the shapes of ``example_args`` (tensors on
    one card); returns ``call(*args)``: ``args`` of those shapes copied into
    the static inputs, one replay, the outputs cloned out.  The capture's
    eager warm-up runs ``fn`` once on the example arguments."""
    from .graphs import StepGraphs
    tensors = [a for a in example_args if isinstance(a, torch.Tensor)]
    devices = {a.device for a in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            "aot_compile captures a CUDA graph: its example arguments must "
            f"lie on one CUDA device, not {sorted(map(str, devices))}")
    static = [a.clone() if isinstance(a, torch.Tensor) else a
              for a in example_args]
    steps = StepGraphs(next(iter(devices)), True)
    out = []

    def body():
        out[:] = [fn(*static)]

    with torch.inference_mode():
        steps.run(("aot",), body)            # the warm-up, then capture

    def call(*args):
        if len(args) != len(static):
            raise TypeError(f"{len(static)} arguments, got {len(args)}")
        with torch.inference_mode():
            for s, a in zip(static, args):
                if isinstance(s, torch.Tensor):
                    if a.shape != s.shape:
                        raise ValueError(f"compiled for {tuple(s.shape)}, "
                                         f"got {tuple(a.shape)}")
                    s.copy_(a)
            steps.run(("aot",), body)
            return _map(torch.clone, out[0])

    call.graphs = steps
    return call


class _Fn(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_serialized(fn_or_module, *example_args) -> bytes:
    """``fn_or_module`` traced by ``torch.export.export`` for the example
    arguments and serialized with ``torch.export.save``.  The tracer cannot
    see through the ``ctypes`` calls of the port's CUDA entries, so export
    the plain path (the kernels off, or tensors on the CPU, where the
    wrappers run their plain versions)."""
    mod = (fn_or_module if isinstance(fn_or_module, nn.Module)
           else _Fn(fn_or_module))
    ep = torch.export.export(mod, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_serialized(data: bytes) -> Callable:
    """A callable module rebuilt from ``export_serialized``'s bytes."""
    return torch.export.load(io.BytesIO(data)).module()


def average_checkpoints(trees: Sequence[Mapping]) -> dict:
    """The uniform mean of nested mappings of tensors of one structure:
    summed in order, then divided by their count, as the JAX package
    does."""
    if not trees:
        raise ValueError("no checkpoints to average")

    def add(a, b):
        if isinstance(a, Mapping):
            return {k: add(a[k], b[k]) for k in a}
        return a + b

    def div(a, n):
        if isinstance(a, Mapping):
            return {k: div(v, n) for k, v in a.items()}
        return a / n

    out = trees[0]
    for tree in trees[1:]:
        out = add(out, tree)
    return div(out, len(trees))
