"""Fused causal-resnet + transformer-group block of the KV wavefront: the CUDA
kernel ``csrc/fused_tf_group.cu`` and its plain PyTorch version.

Replaces the JAX package's Pallas kernel ``ops/pallas_block.py::_kernel``
(entry ``fused_tf_group``).  One call runs, for every wavefront row:

- the group's preceding causal resnet block: conv3 -> LayerNorm -> mish ->
  + time-MLP projection -> conv3 -> LayerNorm -> mish, plus the 1x1
  residual, with the two conv caches in and out;
- then L transformer blocks: LayerNorm -> fused QKV -> the chunk's K/V
  written into the layer's ring (in place) -> attention over the ring with
  the banded mask (slot ``s`` of row ``r`` is valid iff
  ``(s - rot[r]) % rp < nd[r]``) -> out-proj -> LayerNorm -> exact-GELU FF.

Write modes: shared offset (every enabled row writes frame ``f`` of the
chunk at slot ``(offset + f) % rp``) and per row (offset
``(nd[r] - cf) % rp``).  Rows whose enable flag is 0 leave their ring
untouched.  The returned conv caches are unmasked; the caller applies the
enable mask, as the JAX package does.

The per-launch scalars (``scal`` and the shared ``offset``) are read from
device memory, as the TPU kernel reads its scalar prefetch, so a launch
captured in a CUDA graph reads each replay's values.  The wrapper takes
the offset as a host int or as a device int32 and checks only a host
int's range (the kernel takes any offset modulo rp).

Cast points (the TPU kernel's, ``pallas_block.py:76-155, 300-317``): every
product accumulates in f32 and is rounded to the compute dtype; scores are
rounded before the ``head_dim ** -0.5`` scale and again after it; masked
scores are -1e10; the softmax over ring slots is computed in f32 from the
rounded scores and rounded once, then masked weights are zeroed; LayerNorm
is flax's (f32 statistics, fast variance clipped at 0, eps 1e-5); mish and
GELU run in f32 and are rounded once.  Each bias is added after its
product is rounded, and each residual add rounds.

Weights come packed per group (``models/flow/kv_stream.py::
group_estimator_params``): matrices in (in, out) layout, conv kernels
(3, in, out), the transformer leaves stacked on a leading L axis.

Bound on an H100 SXM: a steady launch of the KV session (20 rows, hop 20
frames, ring 160, L 4, bf16) moves about 37 MB (the ring slots it attends
to, the group's weights, the chunk K/V it writes), about 11 us at
3.35 TB/s; its 4.3 GFLOP take 4.3 us on tensor cores, so it is bound by
bytes (in f32, by operations on CUDA cores, about 64 us).  The kernel runs
one thread-block cluster per row (4 CTAs at full width), each CTA a column
slice of every product on tensor cores (bf16) and its share of the heads;
the slices meet through distributed shared memory.  See the source's
header.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel (float32 or bfloat16) or raise.  There is no fall-back.  Either way
the entry counts the JAX package's analytic FLOPs of the launch in an
active ``utils/flops.py`` tally, and the plain version's products none.
``kernel_limit`` names the geometries the kernel cannot run, its shared
memory among them (``cluster_size`` mirrors the launcher's layout).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple, Union

import torch

from . import cuda_build
from .autograd_guard import forbid_autograd
from ..utils.flops import fused_tf_group_flops, kernel_flops

_NEG = -1.0e10
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# packed weights of the group's resnet and of its stacked transformer blocks,
# in the order the kernel takes them
RES_KEYS = ("b1k", "b1b", "b1ls", "b1lb", "mlpk", "mlpb",
            "b2k", "b2b", "b2ls", "b2lb", "resk", "resb")
TF_KEYS = ("n1s", "n1b", "qkvk", "outk", "outb", "n3s", "n3b",
           "ffpk", "ffpb", "ffok", "ffob")


Scalar = Union[int, torch.Tensor]


def group_scalars(nd_mask, rot, enable, device) -> torch.Tensor:
    """(3, rows) int32 [nd_mask; rot; enable] as the kernel reads them;
    from tensors on ``device`` it is built there, with no upload."""
    return torch.stack([torch.as_tensor(a, dtype=torch.int32).reshape(-1)
                        for a in (nd_mask, rot, enable)]).to(device)


def device_scalar(v: Scalar, device) -> torch.Tensor:
    """A (1,) int32 on ``device``: a tensor is cast there (no upload), a
    host int is uploaded."""
    if torch.is_tensor(v):
        if v.numel() != 1 or v.device != torch.device(device):
            raise ValueError(f"a device scalar must hold one value on "
                             f"{device}, got {tuple(v.shape)} on {v.device}")
        return v.reshape(1).to(torch.int32)
    return torch.tensor([int(v)], dtype=torch.int32, device=device)


# ------------------------------------------------------------ plain version
def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * mul + bias.float()).to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def _mish(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    softplus = torch.clamp(xf, min=0.0) + torch.log1p(torch.exp(-xf.abs()))
    return (xf * torch.tanh(softplus)).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * 2.0 ** -0.5))).to(x.dtype)


def _conv3(xf: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """Causal k=3 conv of the cache-prepended (rows, cf + 2, cin) input as
    three shifted f32 products, one f32 sum (rounded by the caller)."""
    cf = xf.shape[1] - 2
    acc = xf[:, 0:cf].float() @ k3[0].float()
    for k in (1, 2):
        acc = acc + xf[:, k:k + cf].float() @ k3[k].float()
    return acc


def fused_tf_group_plain(p: Dict[str, torch.Tensor],
                         rp_: Dict[str, torch.Tensor], mt: torch.Tensor,
                         cc1: torch.Tensor, cc2: torch.Tensor,
                         x: torch.Tensor, rings: torch.Tensor,
                         scal: torch.Tensor, offset: Scalar, *, heads: int,
                         head_dim: int, shared_offset: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """The kernel's function with per-layer tensor ops at its cast points;
    updates ``rings`` in place as the kernel does."""
    n_layers, rows, rp, _ = rings.shape
    cf = x.shape[1]
    dt = x.dtype
    inner = heads * head_dim
    dev = x.device
    nd, rot = scal[0].long(), scal[1].long()
    en = scal[2] != 0

    xf = torch.cat([cc1.to(dt), x], dim=1)
    cc1_new = xf[:, cf:cf + 2].clone()
    hh = _conv3(xf, rp_["b1k"]).to(dt) + rp_["b1b"]
    hh = _mish(_ln(hh, rp_["b1ls"], rp_["b1lb"]))
    hh = hh + (_dot(mt, rp_["mlpk"]) + rp_["mlpb"])
    hf = torch.cat([cc2.to(dt), hh], dim=1)
    cc2_new = hf[:, cf:cf + 2].clone()
    h2 = _conv3(hf, rp_["b2k"]).to(dt) + rp_["b2b"]
    h2 = _mish(_ln(h2, rp_["b2ls"], rp_["b2lb"]))
    xs = h2 + (_dot(x, rp_["resk"]) + rp_["resb"])

    slots = torch.arange(rp, device=dev)
    valid = torch.remainder(slots[None, :] - rot[:, None], rp) < nd[:, None]
    mask = valid[:, None, None, :]                        # (rows,1,1,rp)
    off = (torch.remainder(device_scalar(offset, dev).long(), rp).expand(rows)
           if shared_offset else torch.remainder(nd - cf, rp))
    wslots = torch.remainder(off[:, None]
                             + torch.arange(cf, device=dev)[None, :], rp)
    ridx = torch.arange(rows, device=dev)[:, None].expand(rows, cf)
    neg = torch.full((), _NEG, dtype=dt, device=dev)
    scale = head_dim ** -0.5
    for l in range(n_layers):
        h = _ln(xs, p["n1s"][l], p["n1b"][l])
        qkv = _dot(h, p["qkvk"][l])
        ring = rings[l]
        old = ring[ridx, wslots]
        ring[ridx, wslots] = torch.where(en[:, None, None],
                                         qkv[..., inner:].to(ring.dtype), old)
        kv = ring.to(dt).reshape(rows, rp, 2, heads, head_dim)
        q4 = qkv[..., :inner].reshape(rows, cf, heads, head_dim)
        s = torch.einsum("rchd,rshd->rhcs", q4.float(),
                         kv[:, :, 0].float()).to(dt) * scale
        a = torch.softmax(torch.where(mask, s, neg), dim=-1)
        a = torch.where(mask, a, torch.zeros((), dtype=dt, device=dev))
        o = torch.einsum("rhcs,rshd->rchd", a.float(),
                         kv[:, :, 1].float()).to(dt).reshape(rows, cf, inner)
        x1 = xs + _dot(o, p["outk"][l]) + p["outb"][l]
        ff = _gelu(_dot(_ln(x1, p["n3s"][l], p["n3b"][l]), p["ffpk"][l])
                   + p["ffpb"][l])
        xs = x1 + _dot(ff, p["ffok"][l]) + p["ffob"][l]
    return xs, rings, cc1_new, cc2_new


def kernel_tolerance(want: torch.Tensor) -> float:
    """Largest abs difference allowed between the kernel and the plain
    version whose output is ``want``.  f32: 2e-5, sums taken in another
    order through up to L layers.  bf16: four bf16 ulps of the largest
    |output|: a product whose rounding falls the other way is one ulp of an
    intermediate, and LayerNorm and the residual chain carry it into the
    following layers."""
    if want.dtype == torch.float32:
        return 2e-5
    if want.dtype != torch.bfloat16:
        raise ValueError(f"kernel takes float32 or bfloat16, got {want.dtype}")
    top = want.float().abs().max().item()
    return 4.0 * 2.0 ** (math.frexp(top)[1] - 8) if top > 0 else 0.0


def make_group_inputs(rows: int, cf: int, cin: int, ch: int, heads: int,
                      head_dim: int, n_layers: int, rp: int, dtype,
                      device, seed: int = 0):
    """Seeded random weights and inputs of one group call at the given
    geometry, for holding the kernel against the plain version: (p, rp_,
    mt, cc1, cc2, x, rings).  Weights are scaled by 1/sqrt(fan-in), so
    activations stay O(1) through the layers."""
    g = torch.Generator().manual_seed(seed)
    inner, ff, tdim = heads * head_dim, 4 * ch, 4 * ch

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(device, dtype)

    def mat(*shape, fan_in):
        return rnd(*shape, std=fan_in ** -0.5).contiguous()

    def near_one(*shape):
        return (1.0 + 0.1 * torch.randn(shape, generator=g)).to(device, dtype)

    p = {"n1s": near_one(n_layers, ch), "n1b": rnd(n_layers, ch, std=0.1),
         "qkvk": mat(n_layers, ch, 3 * inner, fan_in=ch),
         "outk": mat(n_layers, inner, ch, fan_in=inner),
         "outb": rnd(n_layers, ch, std=0.1),
         "n3s": near_one(n_layers, ch), "n3b": rnd(n_layers, ch, std=0.1),
         "ffpk": mat(n_layers, ch, ff, fan_in=ch),
         "ffpb": rnd(n_layers, ff, std=0.1),
         "ffok": mat(n_layers, ff, ch, fan_in=ff),
         "ffob": rnd(n_layers, ch, std=0.1)}
    rp_ = {"b1k": mat(3, cin, ch, fan_in=3 * cin), "b1b": rnd(ch, std=0.1),
           "b1ls": near_one(ch), "b1lb": rnd(ch, std=0.1),
           "mlpk": mat(tdim, ch, fan_in=tdim), "mlpb": rnd(ch, std=0.1),
           "b2k": mat(3, ch, ch, fan_in=3 * ch), "b2b": rnd(ch, std=0.1),
           "b2ls": near_one(ch), "b2lb": rnd(ch, std=0.1),
           "resk": mat(cin, ch, fan_in=cin), "resb": rnd(ch, std=0.1)}
    return (p, rp_, rnd(rows, 1, tdim), rnd(rows, 2, cin), rnd(rows, 2, ch),
            rnd(rows, cf, cin), rnd(n_layers, rows, rp, 2 * inner))


# ------------------------------------------------------------------ kernel
def _check(p, rp_, mt, cc1, cc2, x, rings, scal, offset, heads, head_dim,
           act_fn) -> None:
    if act_fn != "gelu":
        raise ValueError(f"fused_tf_group runs exact GELU, got {act_fn!r}")
    if x.dim() != 3 or rings.dim() != 4:
        raise ValueError(f"x (rows, cf, cin) and rings (L, rows, rp, 2*inner) "
                         f"expected, got {tuple(x.shape)} "
                         f"{tuple(rings.shape)}")
    n_layers, rows, rp, d2 = rings.shape
    _, cf, cin = x.shape
    ch = rp_["resb"].shape[-1]
    inner = heads * head_dim
    tdim = mt.shape[-1]
    ff = p["ffpb"].shape[-1]
    want = {
        "x": (x, (rows, cf, cin)), "mt": (mt, (rows, 1, tdim)),
        "cc1": (cc1, (rows, 2, cin)), "cc2": (cc2, (rows, 2, ch)),
        "rings": (rings, (n_layers, rows, rp, 2 * inner)),
        "b1k": (rp_["b1k"], (3, cin, ch)), "b1b": (rp_["b1b"], (ch,)),
        "b1ls": (rp_["b1ls"], (ch,)), "b1lb": (rp_["b1lb"], (ch,)),
        "mlpk": (rp_["mlpk"], (tdim, ch)), "mlpb": (rp_["mlpb"], (ch,)),
        "b2k": (rp_["b2k"], (3, ch, ch)), "b2b": (rp_["b2b"], (ch,)),
        "b2ls": (rp_["b2ls"], (ch,)), "b2lb": (rp_["b2lb"], (ch,)),
        "resk": (rp_["resk"], (cin, ch)), "resb": (rp_["resb"], (ch,)),
        "n1s": (p["n1s"], (n_layers, ch)), "n1b": (p["n1b"], (n_layers, ch)),
        "qkvk": (p["qkvk"], (n_layers, ch, 3 * inner)),
        "outk": (p["outk"], (n_layers, inner, ch)),
        "outb": (p["outb"], (n_layers, ch)),
        "n3s": (p["n3s"], (n_layers, ch)), "n3b": (p["n3b"], (n_layers, ch)),
        "ffpk": (p["ffpk"], (n_layers, ch, ff)),
        "ffpb": (p["ffpb"], (n_layers, ff)),
        "ffok": (p["ffok"], (n_layers, ff, ch)),
        "ffob": (p["ffob"], (n_layers, ch)),
    }
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
    if scal.shape != (3, rows) or scal.dtype != torch.int32 or \
            scal.device != x.device:
        raise ValueError("scal must be int32 (3, rows) on x's device")
    if not 1 <= cf <= rp:
        raise ValueError(f"chunk {cf} must be in [1, ring {rp}]")
    # a device offset is not read here (that would wait for the card and
    # break capture); the kernel takes it modulo rp
    if not torch.is_tensor(offset) and not 0 <= int(offset) < rp:
        raise ValueError(f"offset {offset} outside [0, {rp})")
    for name, dim in (("cin", cin), ("ch", ch), ("inner", inner),
                      ("ff", ff), ("time dim", tdim)):
        if dim % 4:
            raise ValueError(f"{name} {dim} must be a multiple of 4")


_MAX_SMEM = 232448              # bytes a block may use on an H100


def _round_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def _smem_bytes(cf: int, rp: int, cin: int, ch: int, ff: int, tdim: int,
                heads: int, head_dim: int, elem: int, cs: int) -> int:
    """Shared memory of one CTA of a cluster of ``cs`` CTAs: the launcher's
    ``layout()`` in ``csrc/fused_tf_group.cu``, byte for byte."""
    bf = elem == 2
    al, pad = (16, 8) if bf else (4, 4)
    mp = _round_up(cf, 16 if bf else 4)
    rpp = _round_up(rp, 16) if bf else rp
    pc, pin = _round_up(ch, al) + pad, _round_up(cin, al) + pad
    pi = _round_up(heads * head_dim, al) + pad
    pf, pd = _round_up(ff, al) + pad, _round_up(head_dim, al) + pad
    pr = rpp + pad
    hc = -(-heads // cs)                          # heads per CTA, at most

    def r128(b):
        return _round_up(b, 128)

    rows = cf
    u1 = (2 * r128(rows * pc * elem) + r128(hc * rows * pd * elem)
          + r128(rows * pi * elem))
    att_end = u1 + 2 * r128(hc * rpp * pd * elem) + r128(hc * rows * pr * elem)
    ffn_end = u1 + r128(rows * pf * elem)
    pro_end = u1 + r128((rows + 2) * pin * elem) + r128((rows + 2) * pc * elem)
    return (max(att_end, ffn_end, pro_end)
            + r128(max(3 * 128 * 72 * elem if bf else 0, 2 * ch * 4))
            + r128(ch * 4) + 2 * r128(mp * 4)
            + r128(_round_up(tdim, 16) * elem)
            + r128(4 * 32 * 16 * 4 if bf else 0))


def cluster_size(cf: int, rp: int, cin: int, ch: int, ff: int, tdim: int,
                 heads: int, head_dim: int, dtype: torch.dtype) -> int:
    """The cluster the launcher picks: the smaller of 4 and 8 CTAs whose
    shared memory fits, else 0 (it then refuses the launch).  The C entry
    ``fused_tf_group_cluster`` returns the same."""
    elem = 2 if dtype == torch.bfloat16 else 4
    for cs in (4, 8):
        if _smem_bytes(cf, rp, cin, ch, ff, tdim, heads, head_dim, elem,
                       cs) <= _MAX_SMEM:
            return cs
    return 0


def kernel_limit(cf: int, rp: int, cin: int, ch: int, ff: int, tdim: int,
                 heads: int, head_dim: int, dtype: torch.dtype
                 ) -> Optional[str]:
    """Why ``csrc/fused_tf_group.cu`` cannot run this geometry (chunk ``cf``
    frames, ring ``rp`` slots, input ``cin`` and model ``ch`` channels, FF
    and time widths, heads), or None: it reads a head in float4 steps, in
    bf16 holds the chunk's frames in two m16 row tiles, and lays the row
    out in the shared memory of a cluster of 4 or 8 CTAs.  The plain
    version has none of these limits."""
    if head_dim % 4:
        return f"the kernel needs head_dim % 4 == 0, got {head_dim}"
    if dtype == torch.bfloat16 and cf > 32:
        return f"the bf16 kernel takes chunks of at most 32 frames, got {cf}"
    if not cluster_size(cf, rp, cin, ch, ff, tdim, heads, head_dim, dtype):
        need = _smem_bytes(cf, rp, cin, ch, ff, tdim, heads, head_dim,
                           2 if dtype == torch.bfloat16 else 4, 8)
        return (f"the kernel's shared memory for ring {rp}, chunk {cf}, cin "
                f"{cin} needs {need} bytes a CTA even in a cluster of 8, "
                f"over the {_MAX_SMEM} an H100 block may use")
    return None


def _kernel_fn():
    fn = cuda_build.load("fused_tf_group").fused_tf_group
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    return fn


def kernel_cluster(cf: int, rp: int, cin: int, ch: int, ff: int, tdim: int,
                   heads: int, head_dim: int, dtype: torch.dtype) -> int:
    """The compiled launcher's cluster choice for this geometry (0: none
    fits), to hold ``cluster_size`` against; builds the kernel if needed."""
    fn = cuda_build.load("fused_tf_group").fused_tf_group_cluster
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 9
    return fn(_DTYPE_CODE[dtype], cf, cin, ch, tdim, heads, head_dim, ff, rp)


def launch_fused_tf_group(p, rp_, mt, cc1, cc2, x, rings, scal, offset,
                          x_out, cc1_out, cc2_out, heads: int, head_dim: int,
                          shared_offset: bool) -> None:
    """Launches the kernel on the current stream; ``launches`` counts every
    launch.  ``offset`` a host int or a device int32 (read by the kernel).
    Raises on a non-zero CUDA return code."""
    tensors = ([x, mt, cc1, cc2] + [rp_[k] for k in RES_KEYS]
               + [p[k] for k in TF_KEYS] + [rings, x_out, cc1_out, cc2_out,
                                            scal])
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors")
    n_layers, rows, rp, _ = rings.shape
    _, cf, cin = x.shape
    ch, ff = rp_["resb"].shape[-1], p["ffpb"].shape[-1]
    why = kernel_limit(cf, rp, cin, ch, ff, mt.shape[-1], heads, head_dim,
                       x.dtype)
    if why:
        raise ValueError(why)
    tensors.append(device_scalar(offset, x.device))
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(ptrs, _DTYPE_CODE[x.dtype], rows, cf, cin, ch, mt.shape[-1],
                heads, head_dim, ff, n_layers, rp, int(shared_offset), stream)
    launch_fused_tf_group.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_tf_group launch failed: CUDA error {rc}")


launch_fused_tf_group.launches = 0


def fused_tf_group(p: Dict[str, torch.Tensor], rp_: Dict[str, torch.Tensor],
                   mt: torch.Tensor, cc1: torch.Tensor, cc2: torch.Tensor,
                   x: torch.Tensor, rings: torch.Tensor, scal: torch.Tensor,
                   offset: Scalar, *, heads: int, head_dim: int,
                   act_fn: str = "gelu", shared_offset: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """One resnet + a stacked group of L transformer blocks.

    p: the group's transformer leaves (``TF_KEYS``, leading L axis); rp_:
    its resnet (``RES_KEYS``); mt (rows, 1, 4ch) = mish(t_emb); cc1
    (rows, 2, cin) / cc2 (rows, 2, ch) the resnet's conv caches; x
    (rows, cf, cin); rings (L, rows, rp, 2*inner), UPDATED IN PLACE; scal
    (3, rows) int32 [nd_mask = n_done + cf; rot; enable]
    (``group_scalars``); ``offset`` the shared write offset, a host int or a
    device int32 (ignored when ``shared_offset=False``).

    Returns (x_out (rows, cf, ch), rings, cc1_new, cc2_new); the conv
    caches come back unmasked."""
    forbid_autograd("fused_tf_group", "kernel", p, rp_, mt, cc1,
                               cc2, x, rings)
    _check(p, rp_, mt, cc1, cc2, x, rings, scal, offset, heads, head_dim,
           act_fn)
    rows, cf, cin = x.shape
    ch = rp_["resb"].shape[-1]
    with kernel_flops(fused_tf_group_flops(rows, cf, cin, ch,
                                           heads * head_dim, rings.shape[0],
                                           rings.shape[2])):
        if x.device.type == "cpu":
            return fused_tf_group_plain(p, rp_, mt, cc1, cc2, x, rings, scal,
                                        offset, heads=heads,
                                        head_dim=head_dim,
                                        shared_offset=shared_offset)
        x_out = torch.empty((rows, cf, ch), dtype=x.dtype, device=x.device)
        cc1_out = torch.empty_like(cc1)
        cc2_out = torch.empty_like(cc2)
        launch_fused_tf_group(p, rp_, mt, cc1, cc2, x, rings, scal, offset,
                              x_out, cc1_out, cc2_out, heads, head_dim,
                              shared_offset)
        return x_out, rings, cc1_out, cc2_out
