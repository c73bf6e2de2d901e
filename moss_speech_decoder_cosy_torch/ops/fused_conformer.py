"""Fused conformer-layer group of the KV session's encoder hop: the CUDA
kernel ``csrc/fused_conformer_group.cu`` and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/pallas_conformer.py::_kernel``
(entry ``fused_conformer_group``).  One call runs L wenet ``rel_pos``
conformer layers (no macaron FF, no conv module) at batch 1 over a chunk of
C frames, each layer attending to [its K/V ring ++ the chunk]:

    LayerNorm (eps 1e-12) -> q | k | v = h W_qkv + b -> pk = pe W_pos ->
    per head, scores ((q + u) k^T + (q + v) p^T) dk^-0.5 over the Rt ring
    slots and the C chunk frames (ring slot s valid iff s < n_tok, chunk
    columns always) -> softmax -> A V -> + out-proj -> LayerNorm -> swish
    FF -> + ; then the chunk's [k | v] and pk written into the layer's rings
    in place, frame f at slot (n_tok + f) % Rt.

Cast points (the TPU kernel's, ``pallas_conformer.py:78-143`` with
``pallas_block.py:76-85, 114-120``), which are not those of
``fused_tf_group``: every product accumulates in f32 and rounds to the
compute dtype; each bias and residual add rounds, left to right
(``(x + round(a W_o)) + b_o``); ``s1`` and ``s2`` round, their sum rounds,
the scaled sum rounds, with ``dk^-0.5`` itself taken in the compute dtype;
masked scores are -1e10; the softmax follows ``jax.nn.softmax`` on values
of the compute dtype (``x - max`` rounded, ``exp`` rounded, the sum
accumulated in f32 and rounded, the quotient rounded), then masked weights
are zeroed; LayerNorm is flax's (f32 statistics, fast variance clipped at
0); swish runs in f32 and rounds once.

Weights come packed per group (``models/flow/kv_stream.py::
group_encoder_params``): matrices in (in, out) layout, every leaf stacked on
a leading L axis, ``CONF_KEYS`` order.

Bound on an H100 SXM: a group is bound by bytes in both dtypes.  A layer
holds 3.42 M parameters; the blocks group (L 6, C 5, Rt 35) moves about
41.7 MB in bf16, 12.5 us at 3.35 TB/s, the up group (L 4, C 20, Rt 140)
about 29.3 MB, 8.7 us; their 0.2-0.3 GFLOP take a few us even on f32 CUDA
cores.  The kernel is one cooperative launch whose thread blocks split each
product's output columns, so the weight read is spread over the card; see
the source's header.  A block holds 8 staged f32 rows of max(D, FF) in
shared memory, so at D 512 FF is at most 6984 (``kernel_smem_bytes``;
``_check`` refuses wider shapes on any device).

``n_tok`` is read from device memory, as the TPU kernel reads its scalar
prefetch, so a launch captured in a CUDA graph reads each replay's value:
the wrapper takes it as a host int (range-checked) or as a device int32
(not read on the host; the kernel counts a negative value as 0, and so does
the plain version).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel (float32 or bfloat16) or raise.  There is no fall-back.  Either way
the entry counts the JAX package's analytic FLOPs of the launch in an
active ``utils/flops.py`` tally, and the plain version's products none.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import cuda_build
from .autograd_guard import forbid_autograd
from ..utils.flops import fused_conformer_group_flops, kernel_flops
# kernel_tolerance: the fused group's rule (f32 2e-5, four bf16 ulps of the
# largest output), which holds here for the same reasons
from .fused_block import (_DTYPE_CODE, _NEG, Scalar, _dot,  # noqa: F401
                          _ln, device_scalar, kernel_tolerance)

# the group's stacked leaves, in the order the kernel takes them
CONF_KEYS = ("nms", "nmb", "qkvk", "qkvb", "posk", "pbu", "pbv", "outk",
             "outb", "nfs", "nfb", "w1k", "w1b", "w2k", "w2b")
_LN_EPS = 1e-12
_MAX_SMEM = 232448              # bytes a block may use on an H100


# ------------------------------------------------------------ plain version
def _swish(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def fused_conformer_group_plain(p: Dict[str, torch.Tensor], x: torch.Tensor,
                                pos_emb: torch.Tensor, ring_kv: torch.Tensor,
                                ring_pk: torch.Tensor, n_tok: Scalar, *,
                                heads: int, head_dim: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The kernel's function with per-layer tensor ops at its cast points;
    updates ``ring_kv`` and ``ring_pk`` in place as the kernel does."""
    n_layers, _, rt, _ = ring_kv.shape
    c, d = x.shape[1], x.shape[2]
    dt, dev = x.dtype, x.device
    scale = torch.full((), head_dim ** -0.5, dtype=dt, device=dev)
    neg = torch.full((), _NEG, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    if torch.is_tensor(n_tok):
        n_tok = torch.clamp(n_tok.reshape(()).long(), min=0)
    valid = torch.arange(rt + c, device=dev)
    valid = (valid < n_tok) | (valid >= rt)                  # (Tk,)
    wslots = (n_tok + torch.arange(c, device=dev)) % rt
    xs, pe = x[0], pos_emb[0]

    def heads_of(t):                           # (T, D) -> (H, T, dk) in f32
        return t.reshape(t.shape[0], heads, head_dim).transpose(0, 1).float()

    for l in range(n_layers):
        h = _ln(xs, p["nms"][l], p["nmb"][l], _LN_EPS)
        qkv = _dot(h, p["qkvk"][l]) + p["qkvb"][l]
        q, kv_c = qkv[:, :d], qkv[:, d:]
        pk_c = _dot(pe, p["posk"][l])
        ring = ring_kv[l, 0].to(dt)
        k_all = torch.cat([ring[:, :d], kv_c[:, :d]])
        v_all = torch.cat([ring[:, d:], kv_c[:, d:]])
        p_all = torch.cat([ring_pk[l, 0].to(dt), pk_c])
        s1 = (heads_of(q + p["pbu"][l]) @ heads_of(k_all).transpose(1, 2)
              ).to(dt)
        s2 = (heads_of(q + p["pbv"][l]) @ heads_of(p_all).transpose(1, 2)
              ).to(dt)
        s = torch.where(valid, (s1 + s2) * scale, neg)       # (H, C, Tk)
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        a = e / e.float().sum(-1, keepdim=True).to(dt)
        a = torch.where(valid, a, zero)
        o = (a.float() @ heads_of(v_all)).to(dt)              # (H, C, dk)
        o = o.transpose(0, 1).reshape(c, d)
        xs = xs + _dot(o, p["outk"][l]) + p["outb"][l]
        ff = _swish(_dot(_ln(xs, p["nfs"][l], p["nfb"][l], _LN_EPS),
                         p["w1k"][l]) + p["w1b"][l])
        xs = xs + _dot(ff, p["w2k"][l]) + p["w2b"][l]
        ring_kv[l, 0, wslots] = kv_c.to(ring_kv.dtype)
        ring_pk[l, 0, wslots] = pk_c.to(ring_pk.dtype)
    return xs[None], ring_kv, ring_pk


def make_conformer_inputs(n_layers: int, c: int, d: int, heads: int,
                          ff: int, rt: int, dtype, device, seed: int = 0):
    """Seeded random weights and inputs of one group call at the given
    geometry, for holding the kernel against the plain version: (p, x,
    pos_emb, ring_kv, ring_pk).  Matrices are scaled by 1/sqrt(fan-in), so
    activations stay O(1) through the layers."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(device, dtype)

    def mat(k, n):
        return rnd(n_layers, k, n, std=k ** -0.5).contiguous()

    def near_one(n):
        return (1.0 + 0.1 * torch.randn((n_layers, n), generator=g)).to(
            device, dtype)

    p = {"nms": near_one(d), "nmb": rnd(n_layers, d, std=0.1),
         "qkvk": mat(d, 3 * d), "qkvb": rnd(n_layers, 3 * d, std=0.1),
         "posk": mat(d, d), "pbu": rnd(n_layers, d, std=0.1),
         "pbv": rnd(n_layers, d, std=0.1),
         "outk": mat(d, d), "outb": rnd(n_layers, d, std=0.1),
         "nfs": near_one(d), "nfb": rnd(n_layers, d, std=0.1),
         "w1k": mat(d, ff), "w1b": rnd(n_layers, ff, std=0.1),
         "w2k": mat(ff, d), "w2b": rnd(n_layers, d, std=0.1)}
    return (p, rnd(1, c, d), rnd(1, c, d), rnd(n_layers, 1, rt, 2 * d),
            rnd(n_layers, 1, rt, d))


# ------------------------------------------------------------------ kernel
def _check(p, x, pos_emb, ring_kv, ring_pk, n_tok, heads, head_dim,
           act_fn) -> None:
    if act_fn not in ("swish", "silu"):
        raise ValueError(f"fused_conformer_group runs swish, got {act_fn!r}")
    if x.dim() != 3 or ring_kv.dim() != 4:
        raise ValueError(f"x (1, C, D) and ring_kv (L, 1, Rt, 2D) expected, "
                         f"got {tuple(x.shape)} {tuple(ring_kv.shape)}")
    n_layers, _, rt, _ = ring_kv.shape
    b, c, d = x.shape
    if b != 1:
        raise ValueError(f"the encoder hop runs one stream, got batch {b}")
    if heads * head_dim != d:
        raise ValueError(f"heads {heads} x head_dim {head_dim} != D {d}")
    ff = p["w1b"].shape[-1]
    want = {"x": (x, (1, c, d)), "pos_emb": (pos_emb, (1, c, d)),
            "ring_kv": (ring_kv, (n_layers, 1, rt, 2 * d)),
            "ring_pk": (ring_pk, (n_layers, 1, rt, d)),
            "nms": (p["nms"], (n_layers, d)), "nmb": (p["nmb"], (n_layers, d)),
            "qkvk": (p["qkvk"], (n_layers, d, 3 * d)),
            "qkvb": (p["qkvb"], (n_layers, 3 * d)),
            "posk": (p["posk"], (n_layers, d, d)),
            "pbu": (p["pbu"], (n_layers, d)), "pbv": (p["pbv"], (n_layers, d)),
            "outk": (p["outk"], (n_layers, d, d)),
            "outb": (p["outb"], (n_layers, d)),
            "nfs": (p["nfs"], (n_layers, d)), "nfb": (p["nfb"], (n_layers, d)),
            "w1k": (p["w1k"], (n_layers, d, ff)),
            "w1b": (p["w1b"], (n_layers, ff)),
            "w2k": (p["w2k"], (n_layers, ff, d)),
            "w2b": (p["w2b"], (n_layers, d))}
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    # the TPU kernel leaves this unchecked: its one-hot write then keeps
    # the chunk's first Rt frames
    if not 1 <= c <= rt:
        raise ValueError(f"chunk {c} must be in [1, ring {rt}]")
    # a device n_tok is not read here (that would wait for the card and
    # break capture)
    if not torch.is_tensor(n_tok) and int(n_tok) < 0:
        raise ValueError(f"n_tok {n_tok} must be >= 0")
    if d % 8 or ff % 8:
        raise ValueError(f"D {d} and FF {ff} must be multiples of 8")
    if head_dim > 256:
        raise ValueError(f"head_dim {head_dim} must be at most 256")
    need = kernel_smem_bytes(c, d, head_dim, ff, rt)
    if need > _MAX_SMEM:
        raise ValueError(f"the kernel's shared memory for D {d}, FF {ff}, "
                         f"ring {rt} needs {need} bytes a block, over the "
                         f"{_MAX_SMEM} an H100 block may use")


def kernel_smem_bytes(c: int, d: int, head_dim: int, ff: int, rt: int
                      ) -> int:
    """Dynamic shared memory of one block of ``csrc/fused_conformer_group.cu``
    (its ``smem_bytes``, byte for byte): 8 staged f32 rows of max(D, FF),
    the products' reduction, the epilogue's operands and a LayerNorm's scale
    and bias, or the attention's scratch, whichever is larger.  The same in
    both dtypes."""
    prod = 8 * max(d, ff) + 8 * 8 * 16 + 9 * 16 + 2 * d
    attn = rt + c + 2 * head_dim + 256 + 8
    return 4 * max(prod, attn)


def _kernel_fn():
    fn = cuda_build.load("fused_conformer_group").fused_conformer_group
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def launch_config(c: int, d: int, heads: int, head_dim: int, ff: int,
                  n_layers: int, rt: int, dtype: torch.dtype
                  ) -> Tuple[int, int, int]:
    """The compiled launcher's choice for this shape on the current card,
    without a launch: (return code, grid, shared bytes a block); a code
    other than 0 is what a launch would return.  Builds the kernel if
    needed."""
    fn = cuda_build.load("fused_conformer_group").fused_conformer_group_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 2)()
    rc = fn(_DTYPE_CODE[dtype], c, d, heads, head_dim, ff, n_layers, rt, out)
    return rc, out[0], out[1]


def launch_fused_conformer_group(p, x, pos_emb, ring_kv, ring_pk,
                                 n_tok: Scalar, x_out, scratch, heads: int,
                                 head_dim: int) -> None:
    """Launches the kernel on the current stream; ``launches`` counts every
    launch.  ``scratch`` holds C * (5 D + FF) elements of x's dtype;
    ``n_tok`` a host int or a device int32 (read by the kernel).  Raises on
    a non-zero CUDA return code."""
    tensors = ([x, pos_emb] + [p[k] for k in CONF_KEYS]
               + [ring_kv, ring_pk, x_out, scratch])
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("kernel needs 16-byte aligned tensors")
    n_layers, _, rt, _ = ring_kv.shape
    _, c, d = x.shape
    tensors.append(device_scalar(n_tok, x.device))
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(ptrs, _DTYPE_CODE[x.dtype], c, d, heads, head_dim,
                p["w1b"].shape[-1], n_layers, rt, stream)
    launch_fused_conformer_group.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_conformer_group launch failed: CUDA error "
                           f"{rc}")


launch_fused_conformer_group.launches = 0


def fused_conformer_group(p: Dict[str, torch.Tensor], x: torch.Tensor,
                          pos_emb: torch.Tensor, ring_kv: torch.Tensor,
                          ring_pk: torch.Tensor, n_tok: Scalar, *, heads: int,
                          head_dim: int, act_fn: str = "swish"
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """A stacked group of L conformer layers over a chunk and the layers'
    rings (the JAX package's layout).

    p: the group's leaves (``CONF_KEYS``, leading L axis); x (1, C, D);
    pos_emb (1, C, D) the chunk's rows of the position table; ring_kv
    (L, 1, Rt, 2D) and ring_pk (L, 1, Rt, D), UPDATED IN PLACE; n_tok the
    frames written so far, a host int or a device int32.  Raises ValueError
    when C > Rt.

    Returns (x_out (1, C, D), ring_kv, ring_pk)."""
    forbid_autograd("fused_conformer_group", "enc_kernel", p, x,
                               pos_emb, ring_kv, ring_pk)
    if not torch.is_tensor(n_tok):
        n_tok = int(n_tok)
    _check(p, x, pos_emb, ring_kv, ring_pk, n_tok, heads, head_dim, act_fn)
    _, c, d = x.shape
    with kernel_flops(fused_conformer_group_flops(
            ring_kv.shape[0], c, d, ring_kv.shape[2])):
        if x.device.type == "cpu":
            return fused_conformer_group_plain(p, x, pos_emb, ring_kv,
                                               ring_pk, n_tok, heads=heads,
                                               head_dim=head_dim)
        x_out = torch.empty_like(x)
        scratch = torch.empty((c * (5 * d + p["w1b"].shape[-1]),),
                              dtype=x.dtype, device=x.device)
        launch_fused_conformer_group(p, x, pos_emb, ring_kv, ring_pk, n_tok,
                                     x_out, scratch, heads, head_dim)
        return x_out, ring_kv, ring_pk
