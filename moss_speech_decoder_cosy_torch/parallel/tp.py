"""Tensor parallelism for the speech LMs over ``torch.distributed``, after
the JAX package's ``parallel/tp.py`` (the reference scales its LM with
vLLM's megatron layers).

The JAX package annotates each weight with a ``PartitionSpec`` and lets
GSPMD partition the products and insert the all-reduces.  PyTorch has no
GSPMD, so the port issues the collectives itself, megatron's way:

- ``tp_specs(module, tp)``: the JAX package's name rules letter for letter
  (``_COL`` / ``_ROW``, matched on the module that owns the parameter),
  as ``("col", dim)`` / ``("row", dim)`` / None over a torch module's
  parameters (``nn.Linear`` weights are (out, in): a column split is dim
  0 of the weight and the bias, a row split dim 1 of the weight, its bias
  replicated).  A dimension not divisible by ``tp`` stays replicated.
- ``tp_shard_params``: a rank's slices of those parameters.
- ``tensor_parallel(module)``: the module, in place, holding its rank's
  slices, with each ``Qwen2Layer`` (``models/llm/qwen2.py``) and each wenet
  rel-pos attention and feed-forward (the v1 ``TransformerLM``) running
  on its rank's heads and columns: column-parallel q/k/v (and pos) and
  gate/up (``w_1``), row-parallel ``o_proj`` / ``down_proj`` (``linear_out``
  / ``w_2``), one all-reduce a block, the row bias added once after it (as
  JAX adds it after the psum).  The model's own forwards (training,
  prefill, cached decode, teacher forcing) run unchanged on the local
  head counts.

Autograd (megatron's f / g): a replicated tensor entering a rank's own
computation passes ``copy_in`` (identity; the backward sums the ranks'
gradients) and a row-parallel partial product ``reduce_out`` (the
all-reduce; the backward is the identity), so a replicated parameter's
gradient is the same on every rank and a sliced one's is its slice's.

Heads: with q heads divisible by ``tp`` each rank runs its own heads and
the k/v column slice they read (CosyVoice2's 14 q / 2 k/v heads at tp 2);
a k/v slice that does not line up with them (k/v heads fewer than ``tp``)
raises ``NotImplementedError``.  A q split that is not whole heads (the
width divisible, the heads not) gathers the column outputs and runs every
head, then the row product takes its rank's columns.

``tp_full_state`` gathers a shard's slices back into the whole state dict
(what a checkpoint holds, as the JAX trainer saves the global arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.flow.encoder import FeedForward
from ..models.llm.qwen2 import Qwen2Config, Qwen2Layer, Qwen2Model
from ..ops.attention import RelPositionMultiHeadedAttention

# column-parallel Dense modules: kernel (in, out) -> split out dim.
# Covers the Qwen2 backbone (q/k/v/gate/up), the wenet conformer stack of
# TransformerLM / the flow encoder (linear_q/k/v/pos, FF w_1), and the
# diffusers attention (to_q/k/v).
_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
        "linear_q", "linear_k", "linear_v", "linear_pos", "w_1",
        "to_q", "to_k", "to_v")
# row-parallel Dense modules: kernel (in, out) -> split in dim (psum after)
_ROW = ("o_proj", "down_proj", "linear_out", "w_2", "to_out")

Spec = Optional[Tuple[str, int]]


def param_spec(name: str, shape, tp: int) -> Spec:
    """The split of parameter ``name`` (a dotted torch name) of ``shape``
    over ``tp`` ranks, by the JAX package's rule on its flax twin (kernel
    (in, out) = the torch weight transposed)."""
    parts = name.split(".")
    mod = parts[-2] if len(parts) >= 2 and parts[-2] in _COL + _ROW else None
    leaf = parts[-1]
    if mod is None or len(shape) == 0:
        return None
    if mod in _COL:
        if leaf in ("weight", "bias") and shape[0] % tp == 0:
            return ("col", 0)
        return None
    if leaf == "weight" and len(shape) == 2 and shape[1] % tp == 0:
        return ("row", 1)
    return None


def tp_specs(module: Union[nn.Module, Mapping[str, torch.Tensor]],
             tp: int) -> Dict[str, Spec]:
    """Every parameter's split over ``tp`` ranks (a module, or a state
    dict)."""
    items = (module.named_parameters() if isinstance(module, nn.Module)
             else module.items())
    return {n: param_spec(n, tuple(p.shape), tp) for n, p in items}


def tp_shard_params(module: Union[nn.Module, Mapping[str, torch.Tensor]],
                    tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s parameters: the slice of each split one (chunk
    ``rank`` of ``tp`` along its dim), the others whole."""
    state = (dict(module.named_parameters()) if isinstance(module, nn.Module)
             else dict(module))
    specs = tp_specs(state, tp)
    return {n: (p.detach() if specs[n] is None else
                p.detach().chunk(tp, specs[n][1])[rank].clone())
            for n, p in state.items()}


# ----------------------------------------------------------- collectives
class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's last-dim chunk, concatenated; the backward keeps the
    rank's own chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=-1)[r].contiguous(), None


class _Scatter(torch.autograd.Function):
    """The rank's last-dim chunk of a replicated tensor; the backward
    gathers every rank's chunk of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim=-1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        parts = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=-1), None


def copy_in(x, group=None):
    return _CopyIn.apply(x, group)


def reduce_out(x, group=None):
    return _ReduceOut.apply(x, group)


# --------------------------------------------------------------- modules
def _param(t: torch.Tensor, dim: Optional[int]) -> nn.Parameter:
    """A parameter holding ``t``, sliced along ``dim`` (None: whole)."""
    p = nn.Parameter(t.detach().clone())
    p.tp_dim = dim         # read by ``tp_global_norm``, ``tp_full_state``
    return p


class ColumnParallelLinear(nn.Module):
    """A column slice of a Linear: the rank's output columns, or, with
    ``gather``, every rank's columns concatenated (all heads)."""

    def __init__(self, lin: nn.Linear, tp: int, rank: int, group,
                 gather: bool = False):
        super().__init__()
        self.group, self.gather = group, gather
        self.weight = _param(lin.weight.chunk(tp, 0)[rank], 0)
        self.bias = (None if lin.bias is None else
                     _param(lin.bias.chunk(tp, 0)[rank], 0))

    def forward(self, x):
        y = F.linear(copy_in(x, self.group), self.weight, self.bias)
        return _Gather.apply(y, self.group) if self.gather else y


class RowParallelLinear(nn.Module):
    """A row slice of a Linear over the rank's input columns (``scatter``:
    the input holds every column, the rank takes its own), the partial
    products summed over the ranks, the bias added once after."""

    def __init__(self, lin: nn.Linear, tp: int, rank: int, group,
                 scatter: bool = False):
        super().__init__()
        self.group, self.scatter = group, scatter
        self.weight = _param(lin.weight.chunk(tp, 1)[rank], 1)
        self.bias = (None if lin.bias is None else
                     _param(lin.bias, None))

    def forward(self, x):
        if self.scatter:
            x = _Scatter.apply(x, self.group)
        y = reduce_out(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _split(lin: nn.Linear, kind: str, tp: int) -> bool:
    """Whether the JAX rule splits ``lin``'s weight (its owner a
    ``kind`` module)."""
    if kind == "col":
        return lin.weight.shape[0] % tp == 0
    return lin.weight.shape[1] % tp == 0


@dataclasses.dataclass(frozen=True)
class _Heads:
    """A rank's attention layout: q heads [q0, q1) (all when not split),
    k/v heads [k0, k1) that those read, and how each projection runs."""
    q0: int
    q1: int
    k0: int
    k1: int
    q_mode: str        # "local", "gather", "replicated"
    local: bool        # whether the rank runs only its own q heads


def _heads(h: int, hkv: int, dk: int, tp: int, rank: int) -> _Heads:
    if (h * dk) % tp == 0 and h % tp == 0:
        n = h // tp
        q0, q1, mode = rank * n, (rank + 1) * n, "local"
    elif (h * dk) % tp == 0:
        q0, q1, mode = 0, h, "gather"
    else:
        q0, q1, mode = 0, h, "replicated"
    rep = h // hkv
    k0, k1 = q0 // rep, (q1 - 1) // rep + 1
    nq, nk = q1 - q0, k1 - k0
    if nq % nk or any((i - q0) // (nq // nk) != i // rep - k0
                      for i in range(q0, q1)):
        raise NotImplementedError(
            f"{h} q heads over {hkv} k/v heads do not split into whole "
            f"groups over {tp} ranks")
    return _Heads(q0, q1, k0, k1, mode, mode == "local")


def _kv_proj(lin: nn.Linear, hd: _Heads, hkv: int, dk: int, tp: int,
             rank: int, group) -> nn.Module:
    """The k or v projection of a rank: exactly the k/v heads [k0, k1)."""
    split = _split(lin, "col", tp)
    if not hd.local:
        return (ColumnParallelLinear(lin, tp, rank, group, gather=True)
                if split else lin)
    n = hkv * dk // tp
    if split and (hd.k0 * dk, hd.k1 * dk) == (rank * n, (rank + 1) * n):
        return ColumnParallelLinear(lin, tp, rank, group)
    raise NotImplementedError(
        f"{hd.q1 - hd.q0} q heads a rank read k/v heads [{hd.k0}, {hd.k1}),"
        f" not the rank's slice of {hkv} k/v heads over {tp} ranks")


@dataclasses.dataclass(frozen=True)
class _LocalQwen2Config(Qwen2Config):
    """A rank's Qwen2 geometry: its q and k/v head counts, the head width
    kept."""
    local_head_dim: int = 0

    @property
    def head_dim(self) -> int:
        return self.local_head_dim


def _mlp(mod: nn.Module, up: Tuple[str, ...], down: str, tp: int,
         rank: int, group) -> None:
    if all(_split(getattr(mod, n), "col", tp) for n in up) and \
            _split(getattr(mod, down), "row", tp):
        for n in up:
            setattr(mod, n, ColumnParallelLinear(getattr(mod, n), tp, rank,
                                                 group))
        setattr(mod, down, RowParallelLinear(getattr(mod, down), tp, rank,
                                             group))


def _qwen2_layer(layer: Qwen2Layer, tp: int, rank: int, group) -> None:
    c = layer.cfg
    h, hkv, dk = c.num_heads, c.num_kv_heads, c.head_dim
    hd = _heads(h, hkv, dk, tp, rank)
    if hd.q_mode != "replicated":
        layer.q_proj = ColumnParallelLinear(layer.q_proj, tp, rank, group,
                                            gather=hd.q_mode == "gather")
        layer.o_proj = RowParallelLinear(layer.o_proj, tp, rank, group,
                                         scatter=hd.q_mode == "gather")
    layer.k_proj = _kv_proj(layer.k_proj, hd, hkv, dk, tp, rank, group)
    layer.v_proj = _kv_proj(layer.v_proj, hd, hkv, dk, tp, rank, group)
    layer.cfg = _LocalQwen2Config(
        **dataclasses.asdict(c) | dict(num_heads=hd.q1 - hd.q0,
                                       num_kv_heads=hd.k1 - hd.k0),
        local_head_dim=dk)
    _mlp(layer, ("gate_proj", "up_proj"), "down_proj", tp, rank, group)


def _rel_pos_attention(attn: RelPositionMultiHeadedAttention, tp: int,
                       rank: int, group) -> None:
    h, dk = attn.heads, attn.dim // attn.heads
    hd = _heads(h, h, dk, tp, rank)
    if hd.q_mode == "replicated":
        return
    gather = hd.q_mode == "gather"
    for name in ("linear_q", "linear_k", "linear_v", "linear_pos"):
        setattr(attn, name, ColumnParallelLinear(getattr(attn, name), tp,
                                                 rank, group, gather))
    attn.linear_out = RowParallelLinear(attn.linear_out, tp, rank, group,
                                        scatter=gather)
    if not gather:
        for name in ("pos_bias_u", "pos_bias_v"):
            setattr(attn, name, _param(getattr(attn, name)[hd.q0:hd.q1],
                                       0))
        attn.heads, attn.dim = hd.q1 - hd.q0, (hd.q1 - hd.q0) * dk


def tensor_parallel(module: nn.Module, group=None) -> nn.Module:
    """``module`` (a ``Qwen2SpeechLM`` / ``Qwen2Model`` or a v1
    ``TransformerLM``, with its whole weights) made this rank's shard of
    tensor parallelism over ``group`` (default every rank), in place: each
    Qwen2 layer, rel-pos attention and feed-forward as the module doc
    says; everything else replicated."""
    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    for mod in list(module.modules()):
        if isinstance(mod, Qwen2Layer):
            _qwen2_layer(mod, tp, rank, group)
        elif isinstance(mod, RelPositionMultiHeadedAttention):
            _rel_pos_attention(mod, tp, rank, group)
        elif isinstance(mod, FeedForward):
            _mlp(mod, ("w_1",), "w_2", tp, rank, group)
    for mod in module.modules():
        if isinstance(mod, Qwen2Model) and mod.layers:
            mod.cfg = mod.layers[0].cfg
    return module


def tp_full_state(module: nn.Module, group=None) -> Dict[str, torch.Tensor]:
    """The whole (unsharded) state dict of a ``tensor_parallel`` module:
    each sliced parameter's slices gathered over ``group`` along its dim,
    so it loads into the module as built.  Every rank of ``group`` calls
    it."""
    n = dist.get_world_size(group)
    state = module.state_dict()
    for name, p in module.named_parameters():
        dim = getattr(p, "tp_dim", None)
        if dim is None:
            continue
        parts = [torch.empty_like(p) for _ in range(n)]
        dist.all_gather(parts, p.detach().contiguous(), group=group)
        state[name] = torch.cat(parts, dim)
    return state


def tp_global_norm(params, group=None) -> torch.Tensor:
    """The 2-norm of the whole (unsharded) gradient of ``params``: the
    sliced parameters' squares summed over the ranks, the replicated ones
    counted once."""
    def split(p):
        return getattr(p, "tp_dim", None) is not None
    sliced = [p.grad.float() for p in params
              if p.grad is not None and split(p)]
    rep = [p.grad.float() for p in params
           if p.grad is not None and not split(p)]
    dev = params[0].device
    sq_split = torch.zeros((), device=dev)
    if sliced:
        sq_split = torch.stack(torch._foreach_norm(sliced)).square().sum()
    sq_split = sq_split.clone()
    dist.all_reduce(sq_split, group=group)
    sq = sq_split
    if rep:
        sq = sq + torch.stack(torch._foreach_norm(rep)).square().sum()
    return sq.sqrt()
