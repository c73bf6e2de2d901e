"""Incremental KV-cached streaming flow path, after the JAX package's
``models/flow/kv_stream.py``.

Every frame runs through the flow exactly once: each hop pushes only the
new chunk through the encoder and the CFM U-Net, attending to circular KV
rings of the recent past (per conformer layer for the encoder; per U-Net
attention layer AND per ODE step for the estimator).  Causal convs carry
explicit (k-1)-frame caches.

The step functions run the port's own modules (``encoder.py``,
``estimator.py``, ``cfm.py``, ``flow.py``) with their parameters, plus one
re-pack, ``fuse_qkv_params``: each attention's q/k/v projections are
concatenated into one matrix (one product instead of three).  K and V share
one ring per layer, concatenated on the feature axis.

Caches are dicts of tensors laid out as the JAX package's pytrees:

- ``enc``: ``pre`` (B, 2, D), ``kv`` (Nb, B, Rt, 2D), ``pk`` (Nb, 1, Rt, D),
  ``up_conv`` (B, 2s, D), ``ukv`` (Nu, B, Rm, 2D), ``upk`` (Nu, 1, Rm, D);
- ``est``: ``kv`` a tuple of L (S, 2B, R, 2*inner) rings, ``convs``
  {name: (S, 2B, 2, cin)} keyed by ``estimator_conv_cache_names``;
- ``n_tok``: tokens consumed so far: a Python int, or a 0-d int64 tensor on
  the device.

Unlike the JAX package, whose arrays are immutable, the rings and conv
caches are updated IN PLACE; that takes the place of JAX's buffer
donation.

Every per-call position (``n_tok``, ``n_done``, the wavefront's ``w``,
``k_total`` and ``base_frames``, the shared write offset) may be a host int
or a 0-d tensor on the device, as the JAX package threads device scalars
through its stepped wavefront.  With device scalars a step reads no value
on the host and uploads nothing: slices become gathers clamped as JAX's
``dynamic_slice`` clamps, ring writes ``index_copy_`` at computed slots,
and the solver's constants are made once per device (``_solver_consts``).
So a step can be captured in a CUDA graph and replayed with new values
(``pipeline/kv_session.py``).

The encoder hop has two engines: ``encoder_step`` runs the conformer layers
one by one; ``encoder_hop_kernel`` runs each of its two conformer stacks as
one ``fused_conformer_group`` launch (the session's ``enc_kernel`` option).

Two estimator dataflows are ported: concat (``write=None``: attend over
[ring ++ chunk], the caller writes the chunk afterwards) and fused
write-then-attend (``write`` dict: the chunk is written into a ring of
capacity ring + chunk before attention).  Either writes at one shared
offset under per-slot rotated slot numbering (``{"offset", "enable"}``;
``ring_write_dus``; the rings rotated at the wavefront's entry,
``rotate_rings`` or ``extend_rings_for_fused``'s ``rot``) or at each row's
own position (``{"nd", "enable"}``; ``ring_write_rows``, the JAX
package's one-hot write).  ``wave_step`` and ``wave_lanes_step`` take the
dataflow; the continuous batcher's lanes always write per row.

Int8 rings (the JAX package's ``est_quant``): an estimator ring may be a
dict {"v": int8 (..., R, 2d), "s": f32 (..., R, 1)}, each frame quantized
on its own (``quantize_ring_chunk``).  Such rings run the concat dataflow
only: the attention dequantizes the ring and appends the chunk, and the
chunk is written afterwards through ``write_ring_leaf``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cfm import t_span_cosine
from ...ops.activations import mish
from ...ops.attention import _NEG, masked_softmax
from ...ops.embeddings import _abs_pe_table
from ...ops.fused_block import fused_tf_group, group_scalars
from ...ops.fused_conformer import fused_conformer_group
from ...utils.config import EstimatorConfig, FlowConfig

Cache = Dict[str, object]


def _clamp(v, lo: int, hi: Optional[int] = None):
    """``v`` clamped to [lo, hi], a host int or a device scalar."""
    if torch.is_tensor(v):
        return torch.clamp(v, lo, hi)
    return max(v, lo) if hi is None else min(max(v, lo), hi)


def dyn_slice(a: torch.Tensor, start, n: int, dim: int = 0) -> torch.Tensor:
    """``n`` entries of ``a`` along ``dim`` from ``start``, the start clamped
    so they fit (as JAX's ``dynamic_slice`` clamps).  A device ``start`` is
    gathered on the device, with no read on the host."""
    start = _clamp(start, 0, a.shape[dim] - n)
    if torch.is_tensor(start):
        return a.index_select(dim, start.reshape(()) + torch.arange(
            n, device=a.device))
    return a.narrow(dim, start, n)


# --------------------------------------------------------------------------
# param re-pack: per-layer q/k/v projections -> one fused matrix
# --------------------------------------------------------------------------

@torch.no_grad()
def fuse_qkv_params(flow) -> Dict[str, Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]]:
    """{module path: (weight (3*out, in), bias or None)} for every estimator
    ``attn1`` (to_q/to_k/to_v, no bias) and every encoder ``self_attn``
    (linear_q/k/v, bias with zeros where a projection has none).  Row-block
    concatenation only, so each output is the same dot product; every other
    parameter stays shared with ``flow``."""
    out = {}
    for name, mod in flow.named_modules():
        if all(hasattr(mod, n) for n in ("to_q", "to_k", "to_v")):
            out[name] = (torch.cat([mod.to_q.weight, mod.to_k.weight,
                                    mod.to_v.weight], dim=0), None)
        elif all(hasattr(mod, n) for n in ("linear_q", "linear_k",
                                           "linear_v")):
            lins = (mod.linear_q, mod.linear_k, mod.linear_v)
            bias = torch.cat([lin.bias if lin.bias is not None
                              else torch.zeros_like(lin.weight[:, 0])
                              for lin in lins])
            out[name] = (torch.cat([lin.weight for lin in lins], dim=0), bias)
    return out


# --------------------------------------------------------------------------
# ring utilities
# --------------------------------------------------------------------------

def quantize_ring_chunk(chunk: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-frame symmetric int8 quantization of a K/V chunk (..., C, 2d):
    scale ``max|kv| / 127`` over the feature axis in f32, values
    ``round(x / max(s, 1e-20))`` (half to even) clipped to +-127."""
    af = torch.amax(torch.abs(chunk).float(), dim=-1, keepdim=True)
    s = af / 127.0
    v = torch.clamp(torch.round(chunk.float() / torch.clamp(s, min=1e-20)),
                    -127, 127)
    return {"v": v.to(torch.int8), "s": s}


def dequantize_ring(ring: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """{"v": int8, "s": f32} -> (..., R, 2d) in ``dtype``."""
    return (ring["v"].float() * ring["s"]).to(dtype)


def ring_leaf_len(leaf) -> int:
    """Ring capacity of a plain or int8 ring."""
    return (leaf["v"] if isinstance(leaf, dict) else leaf).shape[-2]


def write_ring_leaf(write_fn, ring, chunk: torch.Tensor, *args, **kw):
    """A ring write primitive (``ring_write``, ``ring_write_rows``,
    ``ring_write_dus``) applied to a plain or an int8 ring, in place.  An
    int8 ring: the chunk is quantized per frame, then the f32 image of the
    values and the scales go through the same primitive and the values are
    rounded back to int8 (integers up to 127 are exact in f32)."""
    if not isinstance(ring, dict):
        return write_fn(ring, chunk, *args, **kw)
    qc = quantize_ring_chunk(chunk)
    v = write_fn(ring["v"].float(), qc["v"].float(), *args, **kw)
    ring["v"].copy_(torch.round(v))
    write_fn(ring["s"], qc["s"], *args, **kw)
    return ring


def ring_write(ring: torch.Tensor, chunk: torch.Tensor, n_done: int
               ) -> torch.Tensor:
    """Write ``chunk`` (..., C, d) into the circular ``ring`` (..., R, d) at
    positions ``n_done .. n_done+C (mod R)`` along axis -2, in place; a
    chunk longer than the ring writes only its tail.  An index write, exact
    as the JAX package's one-hot product; ``n_done`` a host int or a device
    scalar."""
    r, c = ring.shape[-2], chunk.shape[-2]
    m = min(c, r)
    idx = (n_done + (c - m) + torch.arange(m, device=ring.device)) % r
    ring.index_copy_(ring.dim() - 2, idx,
                     chunk[..., c - m:, :].to(ring.dtype))
    return ring


def ring_mask(ring_len: int, chunk_len: int, n_done, rot=None,
              fused: bool = False, device=None) -> torch.Tensor:
    """(B|1, 1, chunk, ring[+chunk]) bool attend-mask (JAX ``_ring_mask``):
    ring slot s is valid iff ``(s - rot) % ring_len < n_done``; the concat
    layout appends the chunk's columns, always visible; ``fused``: the chunk
    is already in the ring and ``n_done`` counts it."""
    nd = torch.as_tensor(n_done, device=device).reshape(-1)
    b = nd.shape[0]
    pos = torch.arange(ring_len, device=nd.device)[None, :]
    if rot is not None:
        pos = torch.remainder(pos - torch.as_tensor(rot, device=nd.device)
                              .reshape(-1)[:, None], ring_len)
    ok = pos < nd[:, None]                                   # (B, R)
    if not fused:
        ok = torch.cat([ok.expand(b, ring_len),
                        torch.ones((b, chunk_len), dtype=torch.bool,
                                   device=nd.device)], dim=1)
    return ok[:, None, None, :].expand(b, 1, chunk_len, ok.shape[-1])


def ring_write_rows(ring: torch.Tensor, chunk: torch.Tensor,
                    n_done: torch.Tensor, enable: torch.Tensor
                    ) -> torch.Tensor:
    """Write each row's ``chunk`` (B, C, d) into ``ring`` (B, R, d) at the
    row's own position: frame f of row b at slot ``(n_done[b] + f) % R``,
    in place; rows with ``enable`` False keep their content, and a chunk
    longer than the ring writes only its tail.  The JAX package's
    ``ring_write_batched`` (a one-hot product, a TPU device) as an exact
    index write; ``n_done`` (B,) a tensor on the ring's device."""
    b, r, d = ring.shape
    c = chunk.shape[-2]
    m = min(c, r)
    idx = torch.remainder(n_done.reshape(b, 1) + (c - m)
                          + torch.arange(m, device=ring.device), r)
    idx3 = idx[:, :, None].expand(b, m, d)
    new = torch.where(enable[:, None, None], chunk[:, c - m:].to(ring.dtype),
                      torch.gather(ring, 1, idx3))
    return ring.scatter_(1, idx3, new)


def ring_write_dus(ring: torch.Tensor, chunk: torch.Tensor, offset,
                   enable: torch.Tensor) -> torch.Tensor:
    """Write ``chunk`` (B, C, d) into ``ring`` (B, R, d) at ONE shared
    ``offset`` (frame f at slot ``(offset + f) % R``), in place, touching
    only the chunk's slots; rows with ``enable`` False keep their content.
    The JAX package's two dynamic-update-slices at the ``C - align`` split
    are the case ``offset % C == align`` of this wrap."""
    c, r = chunk.shape[-2], ring.shape[-2]
    slots = (offset + torch.arange(c, device=ring.device)) % r
    old = ring.index_select(1, slots)
    ring.index_copy_(1, slots, torch.where(enable[:, None, None],
                                           chunk.to(ring.dtype), old))
    return ring


def rotate_rings(rings: torch.Tensor, rot: torch.Tensor,
                 inverse: bool = False) -> torch.Tensor:
    """Rolls each row of one layer's rings (B, R, d) along the ring axis by
    the row's ``rot`` (B,), in place: canonical slot numbering (frame f at
    slot f % R) to the rotated numbering of the shared-offset write (slot
    (f + rot) % R), and back with ``inverse``.  The JAX package's
    ``rotate_rings``; once at the concat wavefront's entry and exit.  An
    int8 ring rotates both its leaves."""
    if isinstance(rings, dict):
        for leaf in rings.values():
            rotate_rings(leaf, rot, inverse)
        return rings
    b, r, d = rings.shape
    shift = -rot if inverse else rot
    src = torch.remainder(torch.arange(r, device=rings.device)[None, :]
                          - shift.reshape(b, 1), r)
    return rings.copy_(torch.gather(rings, 1, src[:, :, None].expand(b, r,
                                                                     d)))


# --------------------------------------------------------------------------
# encoder step (UpsampleConformerEncoderStep and its parts)
# --------------------------------------------------------------------------

def rel_pos_attention_step(attn, qkv, x, pos_emb, ring_kv, ring_pk, mask):
    """RelPositionMultiHeadedAttention over [KV ring ++ chunk] (wenet
    ``rel_pos``: the position term is key-indexed, its projection cached
    per slot in ``ring_pk``).  Returns (out, chunk kv (B, C, 2D), chunk pk
    (1, C, D))."""
    b, c, _ = x.shape
    h, dim = attn.heads, attn.dim
    dk = dim // h
    y = F.linear(x, *qkv)
    q, kv_c = y[..., :dim], y[..., dim:]
    pk_c = attn.linear_pos(pos_emb)
    kvs = torch.cat([ring_kv.to(kv_c.dtype), kv_c], dim=1)
    pks = torch.cat([ring_pk.to(pk_c.dtype), pk_c], dim=1)
    tk = kvs.shape[1]
    q = q.reshape(b, c, h, dk)
    q_u = (q + attn.pos_bias_u).transpose(1, 2)
    q_v = (q + attn.pos_bias_v).transpose(1, 2)
    kt = kvs[..., :dim].reshape(b, tk, h, dk).permute(0, 2, 3, 1)
    pt = pks.reshape(pks.shape[0], tk, h, dk).permute(0, 2, 3, 1)
    scores = (q_u @ kt + q_v @ pt) / torch.full(
        (), dk, dtype=x.dtype, device=x.device).sqrt()
    a = masked_softmax(scores, mask)
    vals = kvs[..., dim:].reshape(b, tk, h, dk).transpose(1, 2)
    out = (a @ vals).transpose(1, 2).reshape(b, c, dim)
    return attn.linear_out(out), kv_c, pk_c


def conformer_layer_step(layer, qkv, x, pos_emb, ring_kv, ring_pk, mask):
    """ConformerEncoderLayer over a chunk + KV ring (no macaron FF, no conv
    module, as the port's full layer)."""
    a, kv_c, pk_c = rel_pos_attention_step(
        layer.self_attn, qkv, layer.norm_mha(x), pos_emb, ring_kv, ring_pk,
        mask)
    x = x + a
    return x + layer.feed_forward(layer.norm_ff(x)), kv_c, pk_c


def pre_lookahead_step(pre, x, context, cache):
    """PreLookaheadLayer: conv1 over the chunk + lookahead context, causal
    conv2 with a 2-frame cache.  Returns (out, new cache)."""
    h = F.leaky_relu(pre.conv1(torch.cat([x, context], dim=1)), 0.01)
    h = torch.cat([cache.to(h.dtype), h], dim=1)
    return pre.conv2(h) + x, h[:, h.shape[1] - 2:]


def upsample_step(up, x, cache):
    """Upsample1D: nearest x stride + conv, cache = the last 2*stride
    post-repeat inputs."""
    b, t, d = x.shape
    x = x[:, :, None].expand(b, t, up.stride, d).reshape(b, t * up.stride, d)
    xp = torch.cat([cache.to(x.dtype), x], dim=1)
    return up.conv(xp), xp[:, xp.shape[1] - 2 * up.stride:]


def encoder_step(enc, fused, x, context, cache: Dict, n_tok,
                 pe_tok: torch.Tensor, pe_mel: torch.Tensor):
    """One token chunk (embedded tokens (B, Ct, in)) through the
    UpsampleConformerEncoder with KV rings; ``context`` the embedded
    lookahead tokens, or None at the end of the stream.  Writes the rings in
    place; returns (features (B, Ct*stride, D), new cache)."""
    c = enc.cfg
    if c.pos_enc_layer_type != "rel_pos":
        raise NotImplementedError("KV streaming needs the wenet rel_pos "
                                  "position table")
    b, ct, _ = x.shape
    s = c.upsample_stride
    x = enc.embed(x)
    ctx = (torch.zeros((b, c.pre_lookahead_len, c.output_size),
                       dtype=x.dtype, device=x.device)
           if context is None else enc.embed(context))
    pos = dyn_slice(pe_tok, n_tok, ct)[None].to(x.dtype)
    x, new_pre = pre_lookahead_step(enc.pre_lookahead_layer, x, ctx,
                                    cache["pre"])
    mask = ring_mask(cache["kv"].shape[-2], ct, n_tok, device=x.device)
    kvs, pks = [], []
    for i, layer in enumerate(enc.encoders):
        x, kv_c, pk_c = conformer_layer_step(
            layer, fused[f"encoder.encoders_{i}.self_attn"], x, pos,
            cache["kv"][i], cache["pk"][i], mask)
        kvs.append(kv_c)
        pks.append(pk_c)
    ring_write(cache["kv"], torch.stack(kvs), n_tok)
    ring_write(cache["pk"], torch.stack(pks), n_tok)

    x, new_up = upsample_step(enc.up_layer, x, cache["up_conv"])
    cm, n_mel = ct * s, n_tok * s
    x = enc.up_embed(x)
    pos_up = dyn_slice(pe_mel, n_mel, cm)[None].to(x.dtype)
    mask_up = ring_mask(cache["ukv"].shape[-2], cm, n_mel, device=x.device)
    ukvs, upks = [], []
    for i, layer in enumerate(enc.up_encoders):
        x, kv_c, pk_c = conformer_layer_step(
            layer, fused[f"encoder.up_encoders_{i}.self_attn"], x, pos_up,
            cache["ukv"][i], cache["upk"][i], mask_up)
        ukvs.append(kv_c)
        upks.append(pk_c)
    ring_write(cache["ukv"], torch.stack(ukvs), n_mel)
    ring_write(cache["upk"], torch.stack(upks), n_mel)
    new_cache = dict(cache, pre=new_pre.to(cache["pre"].dtype),
                     up_conv=new_up.to(cache["up_conv"].dtype))
    return enc.after_norm(x), new_cache


# --------------------------------------------------------------------------
# estimator step (EstimatorStep and its parts)
# --------------------------------------------------------------------------

def causal_block_step(blk, x, cache):
    """CausalBlock1D with an explicit conv cache -> (out, new cache)."""
    h, new = blk.conv(x, cache.to(x.dtype))
    return mish(blk.norm(h)), new


def resnet_step(res, x, t_emb, caches: Dict):
    """CausalResnetBlock1D with cached convs -> (out, new caches)."""
    h, c1 = causal_block_step(res.block1, x, caches["block1"])
    h = h + res.mlp(mish(t_emb))[:, None, :]
    h, c2 = causal_block_step(res.block2, h, caches["block2"])
    return h + res.res_conv(x), {"block1": c1, "block2": c2}


def attend_stored(q: torch.Tensor, kvs: torch.Tensor, mask: torch.Tensor,
                  heads: int, head_dim: int) -> torch.Tensor:
    """Attention against the K/V ring in its stored (B, TK, 2*inner)
    [k | v] layout.  q (B, C, inner), mask (B|1, 1, C, TK) -> (B, C, inner);
    scores and softmax over the key axis in q's dtype, masked scores -1e10,
    masked weights zeroed."""
    b, c, inner = q.shape
    tk = kvs.shape[1]
    kv4 = kvs.reshape(b, tk, 2 * heads, head_dim)
    scores = torch.einsum("bkhd,bchd->bhkc", kv4[:, :, :heads],
                          q.reshape(b, c, heads, head_dim))
    scores = scores * head_dim ** -0.5
    mask_t = mask.transpose(-1, -2)                          # (B, 1, TK, C)
    scores = torch.where(mask_t, scores,
                         torch.full((), _NEG, dtype=scores.dtype,
                                    device=scores.device))
    attn = torch.softmax(scores, dim=-2)
    attn = torch.where(mask_t, attn, torch.zeros((), dtype=attn.dtype,
                                                 device=attn.device))
    out = torch.einsum("bkhd,bhkc->bchd", kv4[:, :, heads:], attn)
    return out.reshape(b, c, inner)


def unet_attention_step(attn, w_qkv, x, ring, mask, write=None):
    """UNetAttention over the KV ring.  ``write=None``: attend over
    [ring ++ chunk], return the chunk's [k | v] for the caller to write;
    ``write`` {"offset", "enable"} (one shared offset) or {"nd", "enable"}
    (each row at its own position, the JAX package's ``{"mode": "onehot"}``):
    write the chunk into the ring first (in place), attend over the ring,
    return the ring.  An int8 ring (concat dataflow only) is dequantized
    before the concat."""
    inner = attn.heads * attn.head_dim
    qkv = F.linear(x, w_qkv)
    q, kv_c = qkv[..., :inner], qkv[..., inner:]
    if isinstance(ring, dict):
        if write is not None:
            raise ValueError("int8 rings run the concat dataflow only")
        kvs = torch.cat([dequantize_ring(ring, kv_c.dtype), kv_c], dim=1)
        ret = kv_c
    elif write is None:
        kvs = torch.cat([ring.to(kv_c.dtype), kv_c], dim=1)
        ret = kv_c
    else:
        if "nd" in write:
            ret = ring_write_rows(ring, kv_c, write["nd"], write["enable"])
        else:
            ret = ring_write_dus(ring, kv_c, write["offset"],
                                 write["enable"])
        kvs = ret.to(kv_c.dtype)
    out = attend_stored(q, kvs, mask, attn.heads, attn.head_dim)
    return attn.to_out(out), ret


def transformer_block_step(blk, w_qkv, x, ring, mask, write=None):
    """BasicTransformerBlock with a KV ring -> (out, chunk kv or ring)."""
    a, ret = unet_attention_step(blk.attn1, w_qkv, blk.norm1(x), ring, mask,
                                 write)
    x = x + a
    return x + blk.ff_out(blk.act(blk.ff_proj(blk.norm3(x)))), ret


def estimator_conv_cache_names(cfg: EstimatorConfig):
    """Static walk order of the estimator's causal-conv caches."""
    names = [("down_res_0", "block1"), ("down_res_0", "block2"),
             ("down_conv_0", None)]
    for i in range(cfg.num_mid_blocks):
        names += [(f"mid_res_{i}", "block1"), (f"mid_res_{i}", "block2")]
    names += [("up_res_0", "block1"), ("up_res_0", "block2"),
              ("up_conv_0", None), ("final_block", None)]
    return names


def _check_single_level(c: EstimatorConfig) -> None:
    if not c.causal or len(c.channels) != 1:
        raise NotImplementedError("KV streaming supports the single-level "
                                  "causal U-Net")
    if c.use_flash_attention:
        raise ValueError("KV streaming attends over rings: "
                         "use_flash_attention must be False")


def _embed_inputs(est, x, mu, t, spks, cond):
    t_emb = est.time_mlp(est.time_embeddings(t).to(x.dtype))
    spks_b = spks[:, None, :].expand(x.shape[0], x.shape[1], spks.shape[-1])
    return t_emb, torch.cat([x, mu, spks_b, cond], dim=-1)


def estimator_step(est, fused, x, mu, t, spks, cond, rings: Sequence,
                   convs: Dict, n_done, rot=None, write=None):
    """One chunk through CausalConditionalDecoder (the unfused engine).
    rings: L (B2, Rf, 2*inner) K/V rings in walk order; convs keyed by
    ``estimator_conv_cache_names``; ``write`` as ``unet_attention_step``'s.
    Returns (out, chunk kvs (concat) or the updated rings (``write``), new
    convs)."""
    c = est.cfg
    _check_single_level(c)
    t_emb, h = _embed_inputs(est, x, mu, t, spks, cond)
    cf = h.shape[1]
    rf = ring_leaf_len(rings[0])
    nd = torch.as_tensor(n_done, device=h.device)
    mask = (ring_mask(rf, cf, nd, rot) if write is None
            else ring_mask(rf, cf, nd + cf, rot, fused=True))
    new_convs = {}
    outs = []
    li = 0

    def tf(h, name):
        nonlocal li
        w = fused[f"decoder.estimator.{name}.attn1"][0]
        h, ret = transformer_block_step(getattr(est, name), w, h, rings[li],
                                        mask, write)
        outs.append(ret)
        li += 1
        return h

    h, new_convs["down_res_0"] = resnet_step(est.down_res_0, h, t_emb,
                                             convs["down_res_0"])
    for j in range(c.n_blocks):
        h = tf(h, f"down_tf_0_{j}")
    skip = h
    h, new_convs["down_conv_0"] = est.down_conv_0(
        h, convs["down_conv_0"].to(h.dtype))
    for i in range(c.num_mid_blocks):
        h, new_convs[f"mid_res_{i}"] = resnet_step(
            getattr(est, f"mid_res_{i}"), h, t_emb, convs[f"mid_res_{i}"])
        for j in range(c.n_blocks):
            h = tf(h, f"mid_tf_{i}_{j}")
    h = torch.cat([h, skip], dim=-1)
    h, new_convs["up_res_0"] = resnet_step(est.up_res_0, h, t_emb,
                                           convs["up_res_0"])
    for j in range(c.n_blocks):
        h = tf(h, f"up_tf_0_{j}")
    h, new_convs["up_conv_0"] = est.up_conv_0(h,
                                              convs["up_conv_0"].to(h.dtype))
    h, new_convs["final_block"] = causal_block_step(est.final_block, h,
                                                    convs["final_block"])
    return est.final_proj(h), tuple(outs), new_convs


# --------------------------------------------------------------------------
# CFM: sequential per-hop Euler solve and one wavefront iteration
# --------------------------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _t_span(cfg) -> np.ndarray:
    if cfg.t_scheduler == "cosine":
        return t_span_cosine(cfg.n_timesteps)
    return np.linspace(0, 1, cfg.n_timesteps + 1, dtype=np.float32)


def _compute_dtype(cfg, like: torch.Tensor) -> torch.dtype:
    return (getattr(torch, cfg.estimator_dtype) if cfg.estimator_dtype
            else like.dtype)


def noise_chunk(cfm, start, cf: int, d: int, device) -> torch.Tensor:
    """(cf, d) frames of the CFM's fixed noise from ``start`` (a host int or
    a device scalar), the start clamped so the slice fits the buffer (as
    JAX's dynamic_slice clamps)."""
    return dyn_slice(cfm._z(cfm.cfg.max_noise_len, d, device)[0], start, cf)


def _solver_consts(cfm, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    """The solver's constants in ``dtype`` on ``device``: the t grid
    (S + 1,), its steps (S,) and the CFG rate (), made once per dtype and
    device and kept on the CFM (as its noise buffer is), so a captured step
    uploads nothing."""
    key = (dtype, str(device))
    got = cfm._consts.get(key)
    if got is None:
        t_span = _t_span(cfm.cfg)
        got = cfm._consts[key] = {
            "t": torch.from_numpy(t_span).to(device).to(dtype),
            "dts": torch.from_numpy(np.diff(t_span)).to(device).to(dtype),
            "rate": torch.tensor(cfm.cfg.inference_cfg_rate, dtype=dtype,
                                 device=device)}
    return got


def cfm_step(cfm, fused, mu, spks, cond, est_cache: Dict, n_done,
             temperature: float = 1.0) -> torch.Tensor:
    """CausalConditionalCFMStep: the Euler solve for one chunk, ring[s] and
    convs[s] serving ODE step s; rings and conv caches updated in place.
    Returns the mel chunk (B, cf, n_mel) f32."""
    c = cfm.cfg
    b, cf, d = mu.shape
    sd = torch.float32 if c.solver_dtype == "float32" else mu.dtype
    x = (noise_chunk(cfm, n_done, cf, d, mu.device)[None]
         .expand(b, cf, d).to(sd) * temperature)
    t_span = _t_span(c)
    consts = _solver_consts(cfm, x.dtype, x.device)
    mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    cd = _compute_dtype(c, mu_in)
    rate = consts["rate"]
    for s in range(c.n_timesteps):
        kv_s = tuple(_tree_map(lambda a: a[s], r) for r in est_cache["kv"])
        convs_s = _tree_map(lambda a: a[s], est_cache["convs"])
        x_in = torch.cat([x, x], dim=0).to(cd)
        t_in = torch.full((2 * b,), float(t_span[s]), dtype=cd,
                          device=x.device)
        dphi, ckv, new_convs = estimator_step(
            cfm.estimator, fused, x_in, mu_in.to(cd), t_in, spks_in.to(cd),
            cond_in.to(cd), kv_s, convs_s, n_done)
        dphi = dphi.to(x.dtype)
        dphi = (1.0 + rate) * dphi[:b] - rate * dphi[b:]
        for ring, chunk in zip(kv_s, ckv):
            write_ring_leaf(ring_write, ring, chunk, n_done)
        _tree_map(lambda old, new: old.copy_(new.to(old.dtype)), convs_s,
                  new_convs)
        x = x + consts["dts"][s] * dphi
    return x.float()


def _flat_inputs(cfm, x_wave, mu_wave, spks):
    """The CFG-doubled flat estimator inputs of a wavefront iteration (row
    order s * 2B + cfg * B + b; the CFG half sees zero mu, speaker and
    cond): (x_in, mu_in, t_in, spks_in) in the compute dtype."""
    s_steps, b, cf, d = x_wave.shape
    cd = _compute_dtype(cfm.cfg, mu_wave)
    mu_in = torch.stack([mu_wave, torch.zeros_like(mu_wave)], dim=1).reshape(
        s_steps * 2 * b, cf, d).to(cd)
    x_in = torch.stack([x_wave, x_wave], dim=1).reshape(
        s_steps * 2 * b, cf, d).to(cd)
    spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0).repeat(
        s_steps, 1).to(cd)
    t = _solver_consts(cfm, x_wave.dtype, x_wave.device)["t"][:-1]
    t_in = t[:, None].expand(s_steps, 2 * b).reshape(-1).to(cd)
    return x_in, mu_in, t_in, spks_in


def _wave_inputs(cfm, x_wave, mu_wave, mu_new, spks, w, k_total,
                 base_frames, ring_len: int):
    """Shared front half of a wavefront iteration: the shifted mu wave, the
    CFG-doubled flat estimator inputs (row order s * 2B + cfg * B + b) and
    the per-row scalars, computed on the device from ``w``, ``k_total`` and
    ``base_frames`` (host ints or device scalars)."""
    s_steps, b, cf, d = x_wave.shape
    cd = _compute_dtype(cfm.cfg, mu_wave)
    mu_wave = torch.cat([mu_new[None].to(cd), mu_wave[:-1].to(cd)], dim=0)
    slot = torch.arange(s_steps, device=x_wave.device)
    h_idx = w - slot
    valid = (h_idx >= 0) & (h_idx < k_total)
    n_dones = base_frames + torch.clamp(h_idx, min=0) * cf

    def per_row(a):                    # (S,) -> (S * 2B,), row s * 2B + j
        return a[:, None].expand(s_steps, 2 * b).reshape(-1)

    x_in, mu_in, t_in, spks_in = _flat_inputs(cfm, x_wave, mu_wave, spks)
    rows = dict(nd=per_row(n_dones), rot=per_row((slot * cf) % ring_len),
                enable=per_row(valid))
    return (mu_wave, x_in, mu_in, torch.zeros_like(mu_in), t_in, spks_in,
            rows, (base_frames + w * cf) % ring_len)


def _cfg_euler(cfm, x_wave, dphi):
    """CFG combine of the estimator's (S * 2B, cf, d) output and the Euler
    step of every slot: x_next (S, B, cf, d)."""
    s_steps, b, cf, d = x_wave.shape
    consts = _solver_consts(cfm, x_wave.dtype, x_wave.device)
    rate, dts = consts["rate"], consts["dts"]
    dphi = dphi.reshape(s_steps, 2, b, cf, d).to(x_wave.dtype)
    dphi = (1.0 + rate) * dphi[:, 0] - rate * dphi[:, 1]
    return x_wave + dts[:, None, None, None] * dphi


def _commit_convs(convs, new_convs, enable) -> None:
    """The new conv caches of the enabled rows, in place."""
    en = enable[:, None, None]
    _tree_map(lambda old, new: old.copy_(torch.where(en, new.to(old.dtype),
                                                     old)),
              convs, new_convs)


def _wave_finish(cfm, x_wave, dphi, convs, new_convs, enable, w,
                 base_frames):
    """Shared back half: CFG combine, Euler step, masked conv-cache update
    (in place), the exiting chunk and the noise entering slot 0."""
    s_steps, b, cf, d = x_wave.shape
    x_next = _cfg_euler(cfm, x_wave, dphi)
    _commit_convs(convs, new_convs, enable)
    n_enter = base_frames + _clamp(w + 1, 0) * cf
    z = noise_chunk(cfm, n_enter, cf, d, x_wave.device)[None].expand(
        b, cf, d).to(x_wave.dtype)
    x_shift = torch.cat([z[None], x_next[:-1]], dim=0)
    return x_next[-1].float(), x_shift


def wave_step(cfm, fused, x_wave, mu_wave, mu_new, spks, est_flat: Dict,
              w, k_total, base_frames, dataflow: str = "fused",
              write_mode: str = "dus"):
    """CausalConditionalCFMWave: ONE iteration of the pipelined ODE, slot s
    holding the chunk that has done s Euler steps, all S steps in one
    estimator forward; ``w``, ``k_total`` and ``base_frames`` host ints or
    device scalars; ``est_flat`` in the flat layout, updated in place.

    ``dataflow="fused"`` (write-then-attend): the rings extended to ring +
    chunk (``extend_rings_for_fused``), each layer writing its chunk K/V
    into its ring before attending.  ``"concat"``: the rings at their
    canonical capacity, attention over [ring ++ chunk], the chunk K/V
    written after the estimator.  ``write_mode="dus"``: every row writes at
    one shared offset under the per-slot rotated numbering (rings rotated
    at the wavefront's entry: ``extend_rings_for_fused``'s ``rot``, or
    ``rotate_rings``; needs ring % chunk == 0); ``"onehot"``: each row
    writes at its own n_done, canonical numbering (``ring_write_rows``, the
    JAX package's one-hot write).  Returns (exit mel (B, cf, n_mel) f32,
    valid when S-1 <= w < S-1+k_total; x wave shifted; mu wave)."""
    r = ring_leaf_len(est_flat["kv"][0])
    mu_wave, x_in, mu_in, cond_in, t_in, spks_in, rows, offset = \
        _wave_inputs(cfm, x_wave, mu_wave, mu_new, spks, w, k_total,
                     base_frames, r)
    en, nd = rows["enable"], rows["nd"]
    dus = write_mode == "dus"
    write = None
    if dataflow == "fused":
        write = ({"offset": offset, "enable": en} if dus
                 else {"nd": nd, "enable": en})
    dphi, ckv, new_convs = estimator_step(
        cfm.estimator, fused, x_in, mu_in, t_in, spks_in, cond_in,
        est_flat["kv"], est_flat["convs"], nd, rows["rot"] if dus else None,
        write)
    if write is None:
        for ring, chunk in zip(est_flat["kv"], ckv):
            if dus:
                write_ring_leaf(ring_write_dus, ring, chunk, offset, en)
            else:
                write_ring_leaf(ring_write_rows, ring, chunk, nd, en)
    exit_mel, x_shift = _wave_finish(cfm, x_wave, dphi, est_flat["convs"],
                                     new_convs, en, w, base_frames)
    return exit_mel, x_shift, mu_wave


def _lanes_inputs(cfm, x_wave, mu_wave, mu_buf, spks, w, avail_iters,
                  k_total, base_frames):
    """Front half of a lanes tick (the JAX package's
    ``CausalConditionalCFMWaveLanes.__call__``, fused dataflow): lane l
    advances iff ``w[l] < avail_iters[l]``; an advancing lane's mu wave
    shifts in its chunk ``mu_buf[l, w[l] % cap]``, a stalled lane's stays.
    Returns (mu wave, x_in, mu_in, t_in, spks_in, nd, enable, advance,
    exit_valid): the flat inputs and the per-row nd and enable in row order
    (s, cfg, lane)."""
    s_steps, lanes, cf, _ = x_wave.shape
    dev = x_wave.device
    cd = _compute_dtype(cfm.cfg, mu_wave)
    advance = w < avail_iters                                 # (lanes,)
    mu_new = mu_buf[torch.arange(lanes, device=dev),
                    torch.remainder(torch.clamp(w, min=0), mu_buf.shape[1])]
    mu_wave = torch.where(advance[None, :, None, None],
                          torch.cat([mu_new[None].to(cd), mu_wave[:-1].to(cd)],
                                    dim=0), mu_wave.to(cd))
    h_idx = w[None, :] - torch.arange(s_steps, device=dev)[:, None]
    valid = (h_idx >= 0) & (h_idx < k_total[None, :]) & advance[None, :]
    n_dones = base_frames[None, :] + torch.clamp(h_idx, min=0) * cf

    def per_row(a):                   # (S, lanes) -> (S * 2 * lanes,)
        return a[:, None, :].expand(s_steps, 2, lanes).reshape(-1)

    x_in, mu_in, t_in, spks_in = _flat_inputs(cfm, x_wave, mu_wave, spks)
    return (mu_wave, x_in, mu_in, t_in, spks_in, per_row(n_dones),
            per_row(valid), advance, valid[-1])


def _lanes_finish(cfm, x_wave, dphi, convs, new_convs, enable, advance, w,
                  base_frames):
    """Back half of a lanes tick: CFG combine, Euler step, the enabled rows'
    conv caches (in place), each advancing lane's noise entering slot 0 at
    ``base + (w + 1) * cf`` (clamped so the slice fits the noise buffer);
    a stalled lane's x wave stays.  Returns (exit mel (lanes, cf, d) f32,
    x wave shifted, w + advance)."""
    s_steps, lanes, cf, d = x_wave.shape
    x_next = _cfg_euler(cfm, x_wave, dphi)
    _commit_convs(convs, new_convs, enable)
    noise = cfm._z(cfm.cfg.max_noise_len, d, x_wave.device)[0]
    n_enter = torch.clamp(base_frames + torch.clamp(w + 1, min=0) * cf, 0,
                          noise.shape[0] - cf)
    z = noise[n_enter[:, None] + torch.arange(cf, device=x_wave.device)]
    x_shift = torch.where(advance[None, :, None, None],
                          torch.cat([z[None].to(x_wave.dtype), x_next[:-1]],
                                    dim=0), x_wave)
    return x_next[-1].float(), x_shift, w + advance.to(w.dtype)


def wave_lanes_step(cfm, fused, x_wave, mu_wave, mu_buf, spks,
                    est_flat: Dict, w, avail_iters, k_total, base_frames,
                    dataflow: str = "fused"):
    """One tick of the continuous batcher's lanes wavefront (the JAX
    package's ``CausalConditionalCFMWaveLanes`` under ``KVLaneWaveStep``):
    each lane an independent stream at its own position, all lanes' S slots
    in one estimator forward whose rows (s, cfg, lane) write their chunk
    K/V at their own positions (``ring_write_rows``).  ``dataflow="fused"``
    writes before attending, over rings extended to ring + chunk;
    ``"concat"`` attends over [ring ++ chunk] and writes after the
    estimator, over rings at their canonical capacity.  Both number the
    slots canonically (frame f at slot f % ring).  x / mu waves (S, lanes,
    cf, d); ``mu_buf`` (lanes, cap, cf, d) the lanes' encoded chunks;
    ``est_flat`` updated in place, disabled rows' rings and conv caches
    kept; ``w``, ``avail_iters``, ``k_total``, ``base_frames`` (lanes,)
    tensors.  Returns (exit mel (lanes, cf, d) f32, exit valid (lanes,)
    bool, x wave shifted, mu wave, w + advance)."""
    mu_wave, x_in, mu_in, t_in, spks_in, nd, en, advance, exit_valid = \
        _lanes_inputs(cfm, x_wave, mu_wave, mu_buf, spks, w, avail_iters,
                      k_total, base_frames)
    write = {"nd": nd, "enable": en} if dataflow == "fused" else None
    dphi, ckv, new_convs = estimator_step(
        cfm.estimator, fused, x_in, mu_in, t_in, spks_in,
        torch.zeros_like(mu_in), est_flat["kv"], est_flat["convs"], nd,
        write=write)
    if write is None:
        for ring, chunk in zip(est_flat["kv"], ckv):
            write_ring_leaf(ring_write_rows, ring, chunk, nd, en)
    exit_mel, x_shift, w_next = _lanes_finish(
        cfm, x_wave, dphi, est_flat["convs"], new_convs, en, advance, w,
        base_frames)
    return exit_mel, exit_valid, x_shift, mu_wave, w_next


# --------------------------------------------------------------------------
# flow-level steps
# --------------------------------------------------------------------------

def spk_embedding(flow, embedding: torch.Tensor) -> torch.Tensor:
    """KVFlowEncodeStep.spk: the projected speaker vector."""
    return flow._spk(embedding)


def kv_flow_encode_step(flow, fused, token_chunk, context, enc_cache: Dict,
                        n_tok, pe_tok, pe_mel):
    """KVFlowEncodeStep: tokens (+ lookahead ``context`` tokens, None at the
    end of the stream) -> (mu chunk (B, Ct*ratio, n_mel), new enc cache)."""
    x = flow.input_embedding(torch.clamp(token_chunk, min=0))
    ctx = (None if context is None
           else flow.input_embedding(torch.clamp(context, min=0)))
    h, enc_cache = encoder_step(flow.encoder, fused, x, ctx, enc_cache,
                                n_tok, pe_tok, pe_mel)
    return flow.encoder_proj(h), enc_cache


def kv_flow_step(flow, fused, token_chunk, context, cond_chunk, embedding,
                 cache: Cache, pe_tok, pe_mel, finalize: bool = False):
    """KVFlowStep: one streaming chunk, tokens -> mel, carrying the whole KV
    cache.  ``context`` (B, la) lookahead tokens (ignored when
    ``finalize``); cond_chunk (B, Ct*ratio, n_mel): the prompt mel during
    prefill, zeros after.  Returns (mel (B, Ct*ratio, n_mel) f32, cache)."""
    n_tok = cache["n_tok"]
    mu, enc = kv_flow_encode_step(flow, fused, token_chunk,
                                  None if finalize else context,
                                  cache["enc"], n_tok, pe_tok, pe_mel)
    spks = spk_embedding(flow, embedding)
    mel = cfm_step(flow.decoder, fused, mu, spks, cond_chunk.to(mu.dtype),
                   cache["est"], n_tok * flow.cfg.token_mel_ratio)
    return mel, {"enc": enc, "est": cache["est"],
                 "n_tok": n_tok + token_chunk.shape[1]}


# --------------------------------------------------------------------------
# cache layouts
# --------------------------------------------------------------------------

def init_kv_cache(cfg: FlowConfig, ring_tokens: int, batch: int = 1,
                  dtype=torch.float32, est_dtype=None, device=None,
                  est_quant: bool = False) -> Cache:
    """Zero KV cache for a ``ring_tokens``-token left context;
    ``est_dtype`` overrides the estimator rings' and conv caches' dtype;
    ``est_quant`` stores the estimator rings as int8 values and f32 scales
    (``quantize_ring_chunk``; the concat dataflow only)."""
    e = cfg.encoder
    s, d, rt = e.upsample_stride, e.output_size, ring_tokens

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    enc = {"pre": z(batch, 2, d), "kv": z(e.num_blocks, batch, rt, 2 * d),
           "pk": z(e.num_blocks, 1, rt, d), "up_conv": z(batch, 2 * s, d),
           "ukv": z(e.num_up_blocks, batch, rt * s, 2 * d),
           "upk": z(e.num_up_blocks, 1, rt * s, d)}
    est_cfg = cfg.estimator
    edt = est_dtype or dtype
    inner = est_cfg.num_heads * est_cfg.attention_head_dim
    n_attn = est_cfg.n_blocks * (2 + est_cfg.num_mid_blocks)
    steps, b2 = cfg.cfm.n_timesteps, 2 * batch
    rf = ring_tokens * cfg.token_mel_ratio
    convs = _est_convs(est_cfg, (steps, b2), edt, device)
    kv = tuple(_ring(steps, b2, rf, 2 * inner, dtype=edt, device=device,
                     quant=est_quant)
               for _ in range(n_attn))
    return {"enc": enc, "est": {"kv": kv, "convs": convs}, "n_tok": 0}


def _ring(*shape, dtype, device, quant: bool):
    """A zero ring (..., R, d2): plain in ``dtype``, or int8 values and f32
    scales."""
    if not quant:
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"v": torch.zeros(shape, dtype=torch.int8, device=device),
            "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                             device=device)}


def tensor_leaves(tree):
    """The tensors of nested dicts, tuples and lists, in order."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, tuple, list)):
            yield from tensor_leaves(v)
        else:
            yield v


def est_cache_bytes(est: Dict) -> int:
    """Bytes of an est cache (rings, scales and conv caches): the unit of
    the device-memory plan of ``serving/audio_batcher.py``."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(est))


def _est_convs(est_cfg: EstimatorConfig, lead: Tuple[int, ...], dtype,
               device) -> Dict:
    """Zero estimator conv caches {name: lead + (2, cin)} keyed by
    ``estimator_conv_cache_names``."""
    ch = est_cfg.channels[0]
    convs: Dict = {}
    for name, sub in estimator_conv_cache_names(est_cfg):
        cin = ch
        if name == "down_res_0" and sub == "block1":
            cin = est_cfg.in_channels
        elif name == "up_res_0" and sub == "block1":
            cin = 2 * ch
        arr = torch.zeros(lead + (2, cin), dtype=dtype, device=device)
        if sub is None:
            convs[name] = arr
        else:
            convs.setdefault(name, {})[sub] = arr
    return convs


def init_est_pool(cfg: FlowConfig, rows: int, rp: int, dtype,
                  device=None, quant: bool = False) -> Dict:
    """Zero estimator cache of ``rows`` flat wavefront rows in the kernel's
    grouped layout (``group_est_flat``): rings of ``rp`` slots (int8 values
    and f32 scales with ``quant``), the mid resnets' conv caches stacked.
    ``ungroup_est_flat`` of it gives the flat layout as views of the same
    tensors."""
    est_cfg = cfg.estimator
    n, m = est_cfg.n_blocks, est_cfg.num_mid_blocks
    d2 = 2 * est_cfg.num_heads * est_cfg.attention_head_dim

    def rings():
        return _ring(n, rows, rp, d2, dtype=dtype, device=device,
                     quant=quant)

    convs = _est_convs(est_cfg, (rows,), dtype, device)
    mids = [convs.pop(f"mid_res_{i}") for i in range(m)]
    convs["mid_res"] = {k: torch.stack([md[k] for md in mids])
                        for k in ("block1", "block2")}
    return {"kv": {"down": rings(), "mid": tuple(rings() for _ in range(m)),
                   "up": rings()},
            "convs": convs}


def pe_tables(cfg: FlowConfig, max_tokens: int, device=None):
    """(pe_tok (max_tokens, D), pe_mel (max_tokens*stride, D)) f32 wenet
    ``rel_pos`` tables, uploaded once per session and sliced per hop."""
    d, s = cfg.encoder.output_size, cfg.encoder.upsample_stride
    return (torch.from_numpy(_abs_pe_table(d, max_tokens)).to(device),
            torch.from_numpy(_abs_pe_table(d, max_tokens * s)).to(device))


def est_cache_to_flat(est: Dict) -> Dict:
    """(S, B2, ...) leaves -> (S*B2, ...) views (row order s*B2 + b); both
    leaves of an int8 ring."""
    def flat(a):
        return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))
    return {"kv": tuple(_tree_map(flat, a) for a in est["kv"]),
            "convs": _tree_map(flat, est["convs"])}


def est_cache_from_flat(flat: Dict, s_steps: int) -> Dict:
    """Inverse of est_cache_to_flat: (S*B2, ...) leaves -> (S, B2, ...)
    views (the JAX package's ``est_cache_from_flat``)."""
    def unflat(a):
        return a.reshape((s_steps, a.shape[0] // s_steps) + tuple(a.shape[1:]))
    return {"kv": tuple(_tree_map(unflat, a) for a in flat["kv"]),
            "convs": _tree_map(unflat, flat["convs"])}


def _regather(est: Dict, idx: torch.Tensor, ok: torch.Tensor,
              out: Optional[Sequence[torch.Tensor]] = None) -> Dict:
    """Per-row gather of ring slots: out[row, j] = in[row, idx[row, j]]
    where ``ok``, else zeros.  An index gather, exact (the JAX package's
    one-hot product was a TPU device).  ``out``: rings to write into (the
    session's persistent buffers) instead of new tensors."""
    def go(a, o):
        idx3 = idx[:, :, None].expand(idx.shape[0], idx.shape[1],
                                      a.shape[-1])
        if o is not None:
            return torch.gather(a, 1, idx3, out=o).masked_fill_(
                ~ok[:, :, None], 0)
        return torch.where(ok[:, :, None], torch.gather(a, 1, idx3),
                           torch.zeros((), dtype=a.dtype, device=a.device))
    outs = out if out is not None else [None] * len(est["kv"])
    return {"kv": tuple(go(a, o) for a, o in zip(est["kv"], outs)),
            "convs": est["convs"]}


def extend_rings_for_fused(est_flat: Dict, n_frames: int, cf: int,
                           rot, out=None) -> Dict:
    """Canonical flat rings (rows, R, 2d), frame f at slot f % R -> the
    fused layout of capacity R + cf, frame f at slot (f + rot[row]) %
    (R + cf); the last min(n_frames, R) frames are carried over, every other
    slot is zero.  New ring tensors, or the rings ``out``; conv caches pass
    through."""
    a0 = est_flat["kv"][0]
    rows, r = a0.shape[0], a0.shape[-2]
    rp = r + cf
    rot = torch.as_tensor(rot, dtype=torch.long, device=a0.device).reshape(
        -1).expand(rows)
    n = int(n_frames)
    sp = torch.arange(rp, device=a0.device)[None, :]
    f = (n - 1) - torch.remainder((n - 1) - (sp - rot[:, None]), rp)
    ok = f >= max(n - r, 0)
    idx = torch.where(ok, torch.remainder(f, r), torch.zeros_like(f))
    return _regather(est_flat, idx, ok, out)


def shrink_rings_from_fused(est_ext: Dict, n_frames: int, cf: int,
                            rot, out=None) -> Dict:
    """Inverse of extend_rings_for_fused: the last min(n_frames, R) frames
    back to canonical capacity-R slots (frame f at slot f % R), into new
    tensors or the rings ``out``."""
    a0 = est_ext["kv"][0]
    rows, rp = a0.shape[0], a0.shape[-2]
    r = rp - cf
    rot = torch.as_tensor(rot, dtype=torch.long, device=a0.device).reshape(
        -1).expand(rows)
    n = int(n_frames)
    s = torch.arange(r, device=a0.device)[None, :]
    f = (n - 1) - torch.remainder((n - 1) - s, r)
    ok = (f >= max(n - r, 0)).expand(rows, r)
    idx = torch.where(ok, torch.remainder(f + rot[:, None], rp),
                      torch.zeros_like(ok, dtype=torch.long))
    return _regather(est_ext, idx, ok, out)


# --------------------------------------------------------------------------
# kernel engine: each resnet + transformer group as one fused_tf_group
# launch (ops/fused_block.py)
# --------------------------------------------------------------------------

@torch.no_grad()
def _pack_resnet(res) -> Dict[str, torch.Tensor]:
    def k3(causal):                     # torch (O, I, K) -> (K, I, O)
        return causal.conv.weight.permute(2, 1, 0).contiguous()
    return {
        "b1k": k3(res.block1.conv), "b1b": res.block1.conv.conv.bias,
        "b1ls": res.block1.norm.weight, "b1lb": res.block1.norm.bias,
        "mlpk": res.mlp.weight.t().contiguous(), "mlpb": res.mlp.bias,
        "b2k": k3(res.block2.conv), "b2b": res.block2.conv.conv.bias,
        "b2ls": res.block2.norm.weight, "b2lb": res.block2.norm.bias,
        "resk": res.res_conv.weight[..., 0].t().contiguous(),
        "resb": res.res_conv.bias}


@torch.no_grad()
def _pack_tf_group(blocks, w_qkv: List[torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    def stk(fn):
        return torch.stack([fn(b) for b in blocks]).contiguous()
    return {
        "n1s": stk(lambda b: b.norm1.weight), "n1b": stk(lambda b: b.norm1.bias),
        "qkvk": torch.stack([w.t() for w in w_qkv]).contiguous(),
        "outk": stk(lambda b: b.attn1.to_out.weight.t()),
        "outb": stk(lambda b: b.attn1.to_out.bias),
        "n3s": stk(lambda b: b.norm3.weight), "n3b": stk(lambda b: b.norm3.bias),
        "ffpk": stk(lambda b: b.ff_proj.weight.t()),
        "ffpb": stk(lambda b: b.ff_proj.bias),
        "ffok": stk(lambda b: b.ff_out.weight.t()),
        "ffob": stk(lambda b: b.ff_out.bias)}


def group_estimator_params(flow, fused) -> Dict:
    """The estimator's weights packed once per decoder for the kernel (the
    JAX package's ``stack_estimator_params`` + ``group_estimator_params``):
    each group's transformer leaves stacked on a leading L axis, matrices
    in (in, out) layout, conv kernels (3, in, out).  A one-time copy of the
    resnet and transformer weights; the rest of the estimator stays in
    ``flow``."""
    est = flow.decoder.estimator
    c = est.cfg
    n, m = c.n_blocks, c.num_mid_blocks

    def group(names):
        return _pack_tf_group(
            [getattr(est, nm) for nm in names],
            [fused[f"decoder.estimator.{nm}.attn1"][0] for nm in names])

    return {
        "down_res_0": _pack_resnet(est.down_res_0),
        "down_tf": group([f"down_tf_0_{j}" for j in range(n)]),
        "mid_res": tuple(_pack_resnet(getattr(est, f"mid_res_{i}"))
                         for i in range(m)),
        "mid_tf": tuple(group([f"mid_tf_{i}_{j}" for j in range(n)])
                        for i in range(m)),
        "up_res_0": _pack_resnet(est.up_res_0),
        "up_tf": group([f"up_tf_0_{j}" for j in range(n)])}


def group_est_flat(est_flat: Dict, cfg: EstimatorConfig) -> Dict:
    """Fused flat est cache (kv: 2n + m*n rings) -> the kernel layout: kv
    {"down": (n, rows, Rp, 2d), "mid": tuple of m (n, ...), "up": (n, ...)}
    (new contiguous tensors), the mid resnets' conv caches stacked under
    "mid_res"."""
    n, m = cfg.n_blocks, cfg.num_mid_blocks
    kv = est_flat["kv"]
    convs = dict(est_flat["convs"])
    mids = [convs.pop(f"mid_res_{i}") for i in range(m)]
    convs["mid_res"] = {k: torch.stack([md[k] for md in mids])
                        for k in ("block1", "block2")}
    return {"kv": {"down": torch.stack(kv[:n]),
                   "mid": tuple(torch.stack(kv[n + i * n:n + (i + 1) * n])
                                for i in range(m)),
                   "up": torch.stack(kv[n + m * n:])},
            "convs": convs}


def ungroup_est_flat(est_g: Dict, cfg: EstimatorConfig) -> Dict:
    """Inverse of group_est_flat (views into the grouped tensors; both
    leaves of an int8 ring)."""
    n, m = cfg.n_blocks, cfg.num_mid_blocks
    kv_g = est_g["kv"]

    def layer(g, j):
        return _tree_map(lambda a: a[j], g)
    kv = ([layer(kv_g["down"], j) for j in range(n)]
          + [layer(kv_g["mid"][i], j) for i in range(m) for j in range(n)]
          + [layer(kv_g["up"], j) for j in range(n)])
    convs = dict(est_g["convs"])
    mid_res = convs.pop("mid_res")
    for i in range(m):
        convs[f"mid_res_{i}"] = {k: mid_res[k][i] for k in ("block1",
                                                           "block2")}
    return {"kv": tuple(kv), "convs": convs}


def estimator_step_kernel(gp: Dict, est, x, mu, t, spks, cond, kv_g: Dict,
                          convs: Dict, scal: torch.Tensor, offset,
                          shared_offset: bool = True):
    """The estimator with each resnet + transformer group run by
    ``fused_tf_group`` (the JAX package's ``estimator_step_pallas``); the
    glue (skip concat, down/up convs, final block) stays in PyTorch.
    ``scal`` (3, rows) int32 [n_done + cf; rot; enable], ``offset`` the
    shared write offset (a host int or a device scalar; ignored when
    ``shared_offset`` is False: each row then writes at its own n_done).
    Rings are updated in place; returns (out, new convs in the grouped
    layout, unmasked)."""
    c = est.cfg
    _check_single_level(c)
    t_emb, h = _embed_inputs(est, x, mu, t, spks, cond)
    mt = mish(t_emb)[:, None, :].contiguous()
    kw = dict(heads=c.num_heads, head_dim=c.attention_head_dim,
              act_fn=c.act_fn, shared_offset=shared_offset)

    def rn_group(p, rp_, cc, h, rings):
        h, _, c1, c2 = fused_tf_group(p, rp_, mt, cc["block1"],
                                      cc["block2"], h.contiguous(), rings,
                                      scal, offset, **kw)
        return h, {"block1": c1, "block2": c2}

    new_convs = {}
    h, new_convs["down_res_0"] = rn_group(gp["down_tf"], gp["down_res_0"],
                                          convs["down_res_0"], h,
                                          kv_g["down"])
    skip = h
    h, new_convs["down_conv_0"] = est.down_conv_0(
        h, convs["down_conv_0"].to(h.dtype))
    mid = []
    for i in range(c.num_mid_blocks):
        h, ncc = rn_group(gp["mid_tf"][i], gp["mid_res"][i],
                          _tree_map(lambda a: a[i], convs["mid_res"]), h,
                          kv_g["mid"][i])
        mid.append(ncc)
    new_convs["mid_res"] = {k: torch.stack([md[k] for md in mid])
                            for k in ("block1", "block2")}
    h = torch.cat([h, skip], dim=-1)
    h, new_convs["up_res_0"] = rn_group(gp["up_tf"], gp["up_res_0"],
                                        convs["up_res_0"], h, kv_g["up"])
    h, new_convs["up_conv_0"] = est.up_conv_0(h,
                                              convs["up_conv_0"].to(h.dtype))
    h, new_convs["final_block"] = causal_block_step(est.final_block, h,
                                                    convs["final_block"])
    return est.final_proj(h), new_convs


def wave_step_kernel(gp: Dict, cfm, x_wave, mu_wave, mu_new, spks,
                     est_g: Dict, w, k_total, base_frames):
    """``wave_step`` with the kernel engine (the JAX package's
    ``wave_step_pallas``): the same iteration, one ``fused_tf_group`` launch
    per resnet + transformer group.  ``est_g`` in the ``group_est_flat``
    layout, updated in place."""
    rp = est_g["kv"]["down"].shape[-2]
    mu_wave, x_in, mu_in, cond_in, t_in, spks_in, rows, offset = \
        _wave_inputs(cfm, x_wave, mu_wave, mu_new, spks, w, k_total,
                     base_frames, rp)
    cf = x_wave.shape[2]
    scal = group_scalars(rows["nd"] + cf, rows["rot"], rows["enable"],
                         x_wave.device)
    dphi, new_convs = estimator_step_kernel(
        gp, cfm.estimator, x_in, mu_in, t_in, spks_in, cond_in,
        est_g["kv"], est_g["convs"], scal, offset)
    exit_mel, x_shift = _wave_finish(cfm, x_wave, dphi, est_g["convs"],
                                     new_convs, scal[2] != 0, w,
                                     base_frames)
    return exit_mel, x_shift, mu_wave


def wave_lanes_step_kernel(gp: Dict, cfm, x_wave, mu_wave, mu_buf, spks,
                           est_g: Dict, w, avail_iters, k_total, base_frames):
    """``wave_lanes_step`` with the kernel engine (the JAX package's
    ``wave_lanes_step_pallas``): the same tick, one ``fused_tf_group``
    launch per resnet + transformer group in its per-row write mode
    (``shared_offset=False``: row r writes at ``n_done[r] % rp``, rot 0).
    ``est_g`` in the ``group_est_flat`` layout, updated in place."""
    mu_wave, x_in, mu_in, t_in, spks_in, nd, en, advance, exit_valid = \
        _lanes_inputs(cfm, x_wave, mu_wave, mu_buf, spks, w, avail_iters,
                      k_total, base_frames)
    dev = x_wave.device
    scal = group_scalars(nd + x_wave.shape[2], torch.zeros_like(nd), en, dev)
    # the ignored shared offset, held on the device so a capture uploads
    # nothing
    offset = torch.zeros((1,), dtype=torch.int32, device=dev)
    dphi, new_convs = estimator_step_kernel(
        gp, cfm.estimator, x_in, mu_in, t_in, spks_in,
        torch.zeros_like(mu_in), est_g["kv"], est_g["convs"], scal, offset,
        shared_offset=False)
    exit_mel, x_shift, w_next = _lanes_finish(
        cfm, x_wave, dphi, est_g["convs"], new_convs, scal[2] != 0, advance,
        w, base_frames)
    return exit_mel, exit_valid, x_shift, mu_wave, w_next


# --------------------------------------------------------------------------
# kernel encoder hop: each conformer stack of the encoder as one
# fused_conformer_group launch (ops/fused_conformer.py)
# --------------------------------------------------------------------------

@torch.no_grad()
def _pack_conformer_group(layers, qkv) -> Dict[str, torch.Tensor]:
    def stk(fn):
        return torch.stack([fn(layer) for layer in layers]).contiguous()
    return {
        "nms": stk(lambda m: m.norm_mha.weight),
        "nmb": stk(lambda m: m.norm_mha.bias),
        "qkvk": torch.stack([w.t() for w, _ in qkv]).contiguous(),
        "qkvb": torch.stack([b for _, b in qkv]).contiguous(),
        "posk": stk(lambda m: m.self_attn.linear_pos.weight.t()),
        "pbu": stk(lambda m: m.self_attn.pos_bias_u.reshape(-1)),
        "pbv": stk(lambda m: m.self_attn.pos_bias_v.reshape(-1)),
        "outk": stk(lambda m: m.self_attn.linear_out.weight.t()),
        "outb": stk(lambda m: m.self_attn.linear_out.bias),
        "nfs": stk(lambda m: m.norm_ff.weight),
        "nfb": stk(lambda m: m.norm_ff.bias),
        "w1k": stk(lambda m: m.feed_forward.w_1.weight.t()),
        "w1b": stk(lambda m: m.feed_forward.w_1.bias),
        "w2k": stk(lambda m: m.feed_forward.w_2.weight.t()),
        "w2b": stk(lambda m: m.feed_forward.w_2.bias)}


def group_encoder_params(flow, fused) -> Dict:
    """The encoder's conformer weights packed once per decoder for the
    kernel (the JAX package's ``group_encoder_params``): the leaves of
    ``encoder.encoders_*`` and of ``encoder.up_encoders_*`` each stacked on
    a leading L axis, matrices in (in, out) layout, the q/k/v projections
    fused.  A one-time copy; the rest of the encoder stays in ``flow``."""
    enc = flow.encoder

    def group(prefix, layers):
        return _pack_conformer_group(
            layers, [fused[f"encoder.{prefix}_{i}.self_attn"]
                     for i in range(len(layers))])

    return {"blocks": group("encoders", enc.encoders),
            "up_blocks": group("up_encoders", enc.up_encoders)}


def encoder_hop_kernel(egp: Dict, flow, token_chunk, context, cache: Dict,
                       n_tok, pe_tok, pe_mel):
    """``kv_flow_encode_step`` of a steady hop (``context`` the lookahead
    tokens) with each conformer stack run by ``fused_conformer_group`` (the
    JAX package's ``encoder_hop_pallas``): embed, pre-lookahead, the blocks
    group, upsample, up-embed, the up group, ``after_norm``,
    ``encoder_proj``.  The rings are written in place; returns (mu chunk
    (1, Ct*stride, n_mel), new enc cache)."""
    enc = flow.encoder
    c = enc.cfg
    if c.pos_enc_layer_type != "rel_pos":
        raise NotImplementedError("KV streaming needs the wenet rel_pos "
                                  "position table")
    kw = dict(heads=c.attention_heads,
              head_dim=c.output_size // c.attention_heads,
              act_fn=c.activation)
    ct, s = token_chunk.shape[1], c.upsample_stride
    x = enc.embed(flow.input_embedding(torch.clamp(token_chunk, min=0)))
    ctx = enc.embed(flow.input_embedding(torch.clamp(context, min=0)))
    pos = dyn_slice(pe_tok, n_tok, ct)[None].to(x.dtype)
    x, new_pre = pre_lookahead_step(enc.pre_lookahead_layer, x, ctx,
                                    cache["pre"])
    x, _, _ = fused_conformer_group(egp["blocks"], x.contiguous(), pos,
                                    cache["kv"], cache["pk"], n_tok, **kw)
    x, new_up = upsample_step(enc.up_layer, x, cache["up_conv"])
    cm, n_mel = ct * s, n_tok * s
    x = enc.up_embed(x)
    pos_up = dyn_slice(pe_mel, n_mel, cm)[None].to(x.dtype)
    x, _, _ = fused_conformer_group(egp["up_blocks"], x.contiguous(), pos_up,
                                    cache["ukv"], cache["upk"], n_mel, **kw)
    new_cache = dict(cache, pre=new_pre.to(cache["pre"].dtype),
                     up_conv=new_up.to(cache["up_conv"].dtype))
    return flow.encoder_proj(enc.after_norm(x)), new_cache
