"""The port's ``fused_tf_group`` (its plain version, on the CPU) against the
JAX package's Pallas kernel in interpret mode, f32, on synthetic stacked
weights with L = 2: shared write offset with and without a wrapping split,
the per-row offset mode, disabled rows, rings in ramp-up and full.

Tolerance 2e-5 on the activation, the updated rings and both conv caches:
the two compute the same function in f32 and differ only in the order of
their sums.  A device-held offset gives the same outputs as the host int,
bit for bit.  ``kernel_limit`` and ``cluster_size`` at the full-width
geometries of the KV session (ROADMAP C1)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.ops.pallas_block import (
    fused_tf_group as jax_fused_tf_group)
from moss_speech_decoder_cosy_torch.ops import fused_block as fb
from moss_speech_decoder_cosy_torch.utils.device import resolve_device

TOL = 2e-5
L, S2, CF, CIN, CH, HEADS, HD, RP = 2, 6, 6, 16, 8, 2, 4, 24
INNER = HEADS * HD


def _params(rng):
    def n(*shape, s=None):
        s = s if s is not None else 1.0 / np.sqrt(shape[-2] if len(shape) > 1
                                                   else 1)
        return (rng.randn(*shape) * s).astype(np.float32)

    def ln(*lead):
        return {"scale": 1.0 + 0.1 * n(*lead, CH, s=1.0),
                "bias": 0.1 * n(*lead, CH, s=1.0)}

    p = {"norm1": ln(L), "norm3": ln(L),
         "attn1": {"to_qkv": {"kernel": n(L, CH, 3 * INNER)},
                   "to_out": {"kernel": n(L, INNER, CH),
                              "bias": 0.1 * n(L, CH, s=1.0)}},
         "ff_proj": {"kernel": n(L, CH, 4 * CH),
                     "bias": 0.1 * n(L, 4 * CH, s=1.0)},
         "ff_out": {"kernel": n(L, 4 * CH, CH), "bias": 0.1 * n(L, CH, s=1.0)}}

    def block(cin):
        return {"conv": {"conv": {"kernel": n(3, cin, CH,
                                              s=1.0 / np.sqrt(3 * cin)),
                                  "bias": 0.1 * n(CH, s=1.0)}},
                "norm": {"scale": 1.0 + 0.1 * n(CH, s=1.0),
                         "bias": 0.1 * n(CH, s=1.0)}}

    rp_ = {"block1": block(CIN), "block2": block(CH),
           "mlp": {"kernel": n(4 * CH, CH), "bias": 0.1 * n(CH, s=1.0)},
           "res_conv": {"kernel": n(1, CIN, CH), "bias": 0.1 * n(CH, s=1.0)}}
    return p, rp_


def _pack(p, rp_):
    """JAX leaves -> the port's packed group layout (already (in, out))."""
    t = torch.from_numpy
    tf = {"n1s": p["norm1"]["scale"], "n1b": p["norm1"]["bias"],
          "qkvk": p["attn1"]["to_qkv"]["kernel"],
          "outk": p["attn1"]["to_out"]["kernel"],
          "outb": p["attn1"]["to_out"]["bias"],
          "n3s": p["norm3"]["scale"], "n3b": p["norm3"]["bias"],
          "ffpk": p["ff_proj"]["kernel"], "ffpb": p["ff_proj"]["bias"],
          "ffok": p["ff_out"]["kernel"], "ffob": p["ff_out"]["bias"]}
    b1, b2 = rp_["block1"], rp_["block2"]
    res = {"b1k": b1["conv"]["conv"]["kernel"], "b1b": b1["conv"]["conv"]["bias"],
           "b1ls": b1["norm"]["scale"], "b1lb": b1["norm"]["bias"],
           "mlpk": rp_["mlp"]["kernel"], "mlpb": rp_["mlp"]["bias"],
           "b2k": b2["conv"]["conv"]["kernel"], "b2b": b2["conv"]["conv"]["bias"],
           "b2ls": b2["norm"]["scale"], "b2lb": b2["norm"]["bias"],
           "resk": rp_["res_conv"]["kernel"][0], "resb": rp_["res_conv"]["bias"]}
    return ({k: t(np.ascontiguousarray(v)) for k, v in tf.items()},
            {k: t(np.ascontiguousarray(v)) for k, v in res.items()})


# (name, shared_offset, align, offset, nd_mask per row, enable per row)
CASES = [
    ("shared_align0_rampup", True, 0, 6, [6, 12, 12, 18, 6, 18],
     [1, 1, 1, 1, 1, 1]),
    ("shared_wrap_full_disabled", True, 2, 20, [30, 24, 40, 26, 33, 24],
     [1, 0, 1, 1, 0, 1]),
    ("shared_align0_full_disabled", True, 0, 0, [24, 36, 48, 24, 30, 60],
     [0, 1, 0, 1, 1, 0]),
    ("per_row_mixed", False, 0, 0, [6, 11, 24, 29, 47, 20],
     [1, 1, 0, 1, 1, 1]),
]


@pytest.mark.parametrize("name,shared,align,offset,nd,enable", CASES,
                         ids=[c[0] for c in CASES])
def test_fused_tf_group_matches_jax(name, shared, align, offset, nd, enable):
    rng = np.random.RandomState(len(name))
    p, rp_ = _params(rng)
    x = rng.randn(S2, CF, CIN).astype(np.float32)
    mt = rng.randn(S2, 1, 4 * CH).astype(np.float32)
    cc1 = rng.randn(S2, 2, CIN).astype(np.float32)
    cc2 = rng.randn(S2, 2, CH).astype(np.float32)
    rings = rng.randn(L, S2, RP, 2 * INNER).astype(np.float32)
    rot = np.array([(s // 2) * CF % RP for s in range(S2)], np.int32)
    nd = np.asarray(nd, np.int32)
    en = np.asarray(enable, bool)

    want = jax_fused_tf_group(
        p, rp_, jnp.asarray(mt), jnp.asarray(cc1), jnp.asarray(cc2),
        jnp.asarray(x), jnp.asarray(rings), jnp.asarray(nd),
        jnp.asarray(rot), jnp.asarray(en), jnp.asarray(offset, jnp.int32),
        align=align, heads=HEADS, head_dim=HD, act_fn="gelu",
        shared_offset=shared, interpret=True)

    tp, trp = _pack(p, rp_)
    t_rings = torch.from_numpy(rings.copy())
    before = fb.launch_fused_tf_group.launches
    got = fb.fused_tf_group(
        tp, trp, torch.from_numpy(mt), torch.from_numpy(cc1),
        torch.from_numpy(cc2), torch.from_numpy(x), t_rings,
        fb.group_scalars(nd, rot, en, "cpu"), offset, heads=HEADS,
        head_dim=HD, shared_offset=shared)
    assert fb.launch_fused_tf_group.launches == before   # plain on the CPU
    assert got[1] is t_rings                             # updated in place
    for g, w, what in zip(got, want, ("x", "rings", "cc1", "cc2")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=what)
    # disabled rows leave their rings as they were
    np.testing.assert_array_equal(t_rings.numpy()[:, ~en], rings[:, ~en])
    assert not np.array_equal(t_rings.numpy()[:, en], rings[:, en])


def test_kernel_path_needs_cuda_tensors():
    """A CPU tensor never reaches the kernel's launcher, and asking for the
    card where there is none raises instead of running on the CPU."""
    rng = np.random.RandomState(0)
    tp, trp = _pack(*_params(rng))
    x = torch.zeros(S2, CF, CIN)
    args = (tp, trp, torch.zeros(S2, 1, 4 * CH), torch.zeros(S2, 2, CIN),
            torch.zeros(S2, 2, CH), x, torch.zeros(L, S2, RP, 2 * INNER),
            fb.group_scalars([CF] * S2, [0] * S2, [1] * S2, "cpu"), 0,
            torch.empty(S2, CF, CH), torch.empty(S2, 2, CIN),
            torch.empty(S2, 2, CH))
    before = fb.launch_fused_tf_group.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fb.launch_fused_tf_group(*args, HEADS, HD, True)
    assert fb.launch_fused_tf_group.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


@pytest.mark.parametrize("top,tol", [(0.124, 4 * 2.0 ** -11),
                                     (4.0, 4 * 2.0 ** -5),
                                     (8.5, 4 * 2.0 ** -4)])
def test_kernel_tolerance_is_four_bf16_ulps_of_the_largest_output(top, tol):
    want = torch.tensor([[0.01, -top, 0.0]], dtype=torch.bfloat16)
    assert fb.kernel_tolerance(want) == tol
    assert fb.kernel_tolerance(want.float()) == 2e-5
    with pytest.raises(ValueError):
        fb.kernel_tolerance(want.half())


@pytest.mark.parametrize("cf,head_dim,dtype,why", [
    (20, 64, torch.bfloat16, None), (32, 64, torch.bfloat16, None),
    (33, 64, torch.bfloat16, "at most 32 frames, got 33"),
    (40, 64, torch.float32, None),
    (20, 6, torch.float32, "head_dim % 4 == 0, got 6")])
def test_kernel_limit_names_what_the_cuda_kernel_cannot_hold(cf, head_dim,
                                                             dtype, why):
    """A narrow geometry (ring 80, 64 channels, two heads) whose shared
    memory fits a cluster of 4, so only the chunk and head limits bite."""
    got = fb.kernel_limit(cf, 80, 64, 64, 256, 256, 2, head_dim, dtype)
    assert got is None if why is None else why in got


# (dtype, ring tokens, cluster) at the MOSS estimator's widths, hop 5
# (cf 20): ch 256, FF and time 1024, 8 x 64 heads, every group's cin
SMEM_CASES = [(torch.bfloat16, 35, 4), (torch.bfloat16, 40, 8),
              (torch.bfloat16, 80, 8), (torch.bfloat16, 85, 0),
              (torch.float32, 20, 4), (torch.float32, 45, 8),
              (torch.float32, 50, 0)]


@pytest.mark.parametrize("dtype,ring,cluster", SMEM_CASES,
                         ids=[f"{str(c[0])[6:]}_ring{c[1]}"
                              for c in SMEM_CASES])
def test_kernel_limit_follows_the_shared_memory_layout(dtype, ring, cluster):
    """The launcher's cluster choice as ``cluster_size`` mirrors it, and a
    reason naming shared memory exactly where no cluster fits."""
    rp = 4 * ring + 20
    for cin in (320, 256, 512):
        geometry = (20, rp, cin, 256, 1024, 1024, 8, 64, dtype)
        assert fb.cluster_size(*geometry) == cluster
        why = fb.kernel_limit(*geometry)
        assert (why is None) == (cluster > 0)
        if why:
            assert "shared memory" in why and f"ring {rp}" in why


@pytest.mark.parametrize("case", ["shared_wrap", "shared_int64_0d",
                                  "per_row"])
def test_device_offset_matches_int_offset(case):
    """The wrapper with the offset held in a tensor (as the KV session's
    captured steps pass it) against the host int, at a wrapping shared
    write: identical outputs and rings."""
    shared = case != "per_row"
    offset = 20
    held = (torch.tensor(offset, dtype=torch.int64) if case.endswith("0d")
            else torch.tensor([offset], dtype=torch.int32))
    p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
        S2, CF, CIN, CH, HEADS, HD, L, RP, torch.float32, "cpu", seed=5)
    scal = fb.group_scalars([30, 24, 40, 26, 33, 24], [0, 0, 6, 6, 12, 12],
                            [1, 0, 1, 1, 0, 1], "cpu")
    r_int, r_dev = rings.clone(), rings.clone()
    kw = dict(heads=HEADS, head_dim=HD, shared_offset=shared)
    want = fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, r_int, scal, offset,
                             **kw)
    got = fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, r_dev, scal, held, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(r_dev, rings)


def test_wrapper_rejects_what_the_kernel_cannot_run():
    rng = np.random.RandomState(1)
    tp, trp = _pack(*_params(rng))
    scal = fb.group_scalars([CF] * S2, [0] * S2, [1] * S2, "cpu")
    base = dict(p=tp, rp_=trp, mt=torch.zeros(S2, 1, 4 * CH),
                cc1=torch.zeros(S2, 2, CIN), cc2=torch.zeros(S2, 2, CH),
                x=torch.zeros(S2, CF, CIN),
                rings=torch.zeros(L, S2, RP, 2 * INNER), scal=scal, offset=0)
    kw = dict(heads=HEADS, head_dim=HD)
    with pytest.raises(ValueError, match="GELU"):
        fb.fused_tf_group(**base, act_fn="silu", **kw)
    with pytest.raises(ValueError, match="rings: dtype"):
        fb.fused_tf_group(**dict(base, rings=base["rings"].bfloat16()), **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fb.fused_tf_group(**{k: v.double() if k in ("x", "mt", "cc1", "cc2",
                                                    "rings") else v
                             for k, v in base.items()}, **kw)
    with pytest.raises(ValueError, match="offset"):
        fb.fused_tf_group(**dict(base, offset=RP), **kw)
    with pytest.raises(ValueError, match="cc2"):
        fb.fused_tf_group(**dict(base, cc2=torch.zeros(S2, 3, CH)), **kw)
