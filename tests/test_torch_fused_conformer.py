"""The port's ``fused_conformer_group`` (its plain version, on the CPU)
against the JAX package's Pallas kernel in interpret mode, on synthetic
stacked weights with L = 2, D 16, 2 heads, FF 24: rings of 6 slots with
chunks of 3 and 6 frames, and of 24 slots with a chunk of 12; n_tok at 0,
in ramp-up, with the ring just full, past full, and with a write that wraps.

Tolerances on x_out and both updated rings:
- f32: 2e-5, the two compute the same function in f32 and differ only in
  the order of their sums;
- bf16: four bf16 ulps of the largest output (``kernel_tolerance``): both
  round at the same points, but a sum taken in another order (or kept in
  f32 a step longer by XLA) can round the other way, by one ulp of an
  intermediate, and LayerNorm and the residual chain carry that into the
  following layer.

A device-held ``n_tok`` gives the same outputs as the host int, bit for
bit, and a negative device ``n_tok`` counts as 0."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.ops.pallas_conformer import (
    fused_conformer_group as jax_fused_conformer_group)
from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc

L, D, HEADS, FF = 2, 16, 2, 24
HD = D // HEADS


def _params(rng):
    def n(*shape, s=None):
        s = s if s is not None else 1.0 / np.sqrt(shape[-2])
        return (rng.randn(*shape) * s).astype(np.float32)

    def ln():
        return {"scale": 1.0 + 0.1 * n(L, D, s=1.0),
                "bias": 0.1 * n(L, D, s=1.0)}

    return {"norm_mha": ln(), "norm_ff": ln(),
            "self_attn": {
                "linear_qkv": {"kernel": n(L, D, 3 * D),
                               "bias": 0.1 * n(L, 3 * D, s=1.0)},
                "linear_pos": {"kernel": n(L, D, D)},
                "pos_bias_u": 0.3 * n(L, HEADS, HD, s=1.0),
                "pos_bias_v": 0.3 * n(L, HEADS, HD, s=1.0),
                "linear_out": {"kernel": n(L, D, D),
                               "bias": 0.1 * n(L, D, s=1.0)}},
            "feed_forward": {"w_1": {"kernel": n(L, D, FF),
                                     "bias": 0.1 * n(L, FF, s=1.0)},
                             "w_2": {"kernel": n(L, FF, D),
                                     "bias": 0.1 * n(L, D, s=1.0)}}}


def _pack(p, dtype):
    """JAX leaves -> the port's packed group (already (in, out))."""
    at, ff = p["self_attn"], p["feed_forward"]
    leaves = {"nms": p["norm_mha"]["scale"], "nmb": p["norm_mha"]["bias"],
              "qkvk": at["linear_qkv"]["kernel"],
              "qkvb": at["linear_qkv"]["bias"],
              "posk": at["linear_pos"]["kernel"],
              "pbu": at["pos_bias_u"].reshape(L, D),
              "pbv": at["pos_bias_v"].reshape(L, D),
              "outk": at["linear_out"]["kernel"],
              "outb": at["linear_out"]["bias"],
              "nfs": p["norm_ff"]["scale"], "nfb": p["norm_ff"]["bias"],
              "w1k": ff["w_1"]["kernel"], "w1b": ff["w_1"]["bias"],
              "w2k": ff["w_2"]["kernel"], "w2b": ff["w_2"]["bias"]}
    assert set(leaves) == set(fc.CONF_KEYS)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
            for k, v in leaves.items()}


# (name, Rt, C, n_tok)
CASES = [("first_chunk", 6, 3, 0), ("rampup", 6, 3, 3),
         ("full", 6, 3, 6), ("wrap", 6, 3, 10),
         ("chunk_is_ring", 6, 6, 8), ("rt24_rampup", 24, 12, 12),
         ("rt24_wrap", 24, 12, 30)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name,rt,c,n_tok", CASES, ids=[c[0] for c in CASES])
def test_fused_conformer_group_matches_jax(name, rt, c, n_tok, dname):
    jdt, tdt = DTYPES[dname]
    rng = np.random.RandomState(rt * 100 + c + n_tok)
    p = _params(rng)
    x = rng.randn(1, c, D).astype(np.float32)
    pe = rng.randn(1, c, D).astype(np.float32)
    ring_kv = rng.randn(L, 1, rt, 2 * D).astype(np.float32)
    ring_pk = rng.randn(L, 1, rt, D).astype(np.float32)

    # the same values in both packages: rounded to the dtype once
    tp = _pack(p, tdt)
    tx, tpe, tkv, tpk = (torch.from_numpy(a).to(tdt)
                         for a in (x, pe, ring_kv, ring_pk))
    jp = {"norm_mha": {k: jnp.asarray(tp["nms" if k == "scale" else "nmb"]
                                      .float().numpy(), jdt)
                       for k in ("scale", "bias")},
          "norm_ff": {k: jnp.asarray(tp["nfs" if k == "scale" else "nfb"]
                                     .float().numpy(), jdt)
                      for k in ("scale", "bias")}}

    def j(key, shape=None):
        a = tp[key].float().numpy()
        return jnp.asarray(a if shape is None else a.reshape(shape), jdt)

    jp["self_attn"] = {
        "linear_qkv": {"kernel": j("qkvk"), "bias": j("qkvb")},
        "linear_pos": {"kernel": j("posk")},
        "pos_bias_u": j("pbu", (L, HEADS, HD)),
        "pos_bias_v": j("pbv", (L, HEADS, HD)),
        "linear_out": {"kernel": j("outk"), "bias": j("outb")}}
    jp["feed_forward"] = {"w_1": {"kernel": j("w1k"), "bias": j("w1b")},
                          "w_2": {"kernel": j("w2k"), "bias": j("w2b")}}
    want = jax_fused_conformer_group(
        jp, *(jnp.asarray(t.float().numpy(), jdt) for t in (tx, tpe, tkv,
                                                            tpk)),
        n_tok, heads=HEADS, head_dim=HD, act_fn="swish", interpret=True)

    kv_before, pk_before = tkv.clone(), tpk.clone()
    before = fc.launch_fused_conformer_group.launches
    got = fc.fused_conformer_group(tp, tx, tpe, tkv, tpk, n_tok, heads=HEADS,
                                   head_dim=HD)
    assert fc.launch_fused_conformer_group.launches == before  # plain on CPU
    assert got[1] is tkv and got[2] is tpk                     # in place
    for g, w, what in zip(got, want, ("x", "ring_kv", "ring_pk")):
        assert g.dtype == tdt and tuple(g.shape) == tuple(w.shape), what
        w_t = torch.from_numpy(np.asarray(w.astype(jnp.float32))).to(tdt)
        tol = fc.kernel_tolerance(w_t)
        err = (g.float() - w_t.float()).abs().max().item()
        assert err <= tol, (what, err, tol)
    # exactly the chunk's slots changed, frame f at (n_tok + f) % Rt
    slots = sorted((n_tok + f) % rt for f in range(c))
    others = [s for s in range(rt) if s not in slots]
    assert torch.equal(tkv[:, :, others], kv_before[:, :, others])
    assert torch.equal(tpk[:, :, others], pk_before[:, :, others])


def _small_inputs(rt=6, c=3):
    return fc.make_conformer_inputs(L, c, D, HEADS, FF, rt, torch.float32,
                                    "cpu", seed=3)


def test_chunk_longer_than_ring_raises():
    """The TPU kernel leaves C > Rt unchecked (its one-hot write then keeps
    the chunk's first Rt frames); the port refuses it."""
    p, x, pe, kv, pk = _small_inputs(rt=6, c=8)
    with pytest.raises(ValueError, match="chunk 8 must be in"):
        fc.fused_conformer_group(p, x, pe, kv, pk, 0, heads=HEADS,
                                 head_dim=HD)


def test_wrapper_rejects_what_the_kernel_cannot_run():
    p, x, pe, kv, pk = _small_inputs()
    kw = dict(heads=HEADS, head_dim=HD)
    with pytest.raises(ValueError, match="swish"):
        fc.fused_conformer_group(p, x, pe, kv, pk, 0, act_fn="gelu", **kw)
    with pytest.raises(ValueError, match="ring_pk: dtype"):
        fc.fused_conformer_group(p, x, pe, kv, pk.bfloat16(), 0, **kw)
    with pytest.raises(ValueError, match="heads"):
        fc.fused_conformer_group(p, x, pe, kv, pk, 0, heads=4, head_dim=HD)
    with pytest.raises(ValueError, match="one stream"):
        fc.fused_conformer_group(p, x.expand(2, -1, -1), pe, kv, pk, 0, **kw)
    with pytest.raises(ValueError, match="w2k"):
        fc.fused_conformer_group(dict(p, w2k=p["w2k"][:, :8]), x, pe, kv, pk,
                                 0, **kw)
    with pytest.raises(ValueError, match="n_tok"):
        fc.fused_conformer_group(p, x, pe, kv, pk, -1, **kw)


@pytest.mark.parametrize("n_layers,c,d,heads,ff,rt,fits", [
    (6, 5, 512, 8, 2048, 35, True),
    (4, 20, 512, 8, 2048, 140, True),
    (1, 1, 512, 8, 6984, 1, True),
    (1, 1, 512, 8, 6992, 1, False),
], ids=["blocks_group", "up_group", "widest_ff", "past_widest_ff"])
def test_wrapper_names_the_kernels_shared_memory(n_layers, c, d, heads, ff,
                                                 rt, fits):
    """The kernel's block holds 8 staged f32 rows of max(D, FF): the
    encoder's two full-width groups fit, so does FF 6984 at D 512, and the
    next FF is refused by the wrapper with a ValueError naming shared
    memory, on any device."""
    p, x, pe, kv, pk = fc.make_conformer_inputs(n_layers, c, d, heads, ff,
                                                rt, torch.bfloat16, "cpu")
    need = fc.kernel_smem_bytes(c, d, d // heads, ff, rt)
    assert (need <= 232448) == fits
    if fits:
        fc._check(p, x, pe, kv, pk, 0, heads, d // heads, "swish")
    else:
        with pytest.raises(ValueError, match=f"shared memory .* needs {need}"):
            fc.fused_conformer_group(p, x, pe, kv, pk, 0, heads=heads,
                                     head_dim=d // heads)


def test_phase_stamps_find_every_barrier():
    """``bin/conformer_phases`` stamps the kernel source by its text: a
    stamp at the start, before and after each of the five grid barriers of
    a layer, and at the end."""
    from pathlib import Path
    from moss_speech_decoder_cosy_torch.bin import conformer_phases as cp
    from moss_speech_decoder_cosy_torch.ops import cuda_build
    src = Path(cuda_build.CSRC / "fused_conformer_group.cu").read_text()
    assert src.count("grid.sync();") == 5
    stamped = cp.instrument(src)
    assert stamped.count("PHASE_STAMP();") == 1 + 2 * 5 + 1
    assert "g_phase_grid = (int)cfg.gridDim.x;" in stamped


def test_kernel_path_needs_cuda_tensors():
    """A CPU tensor never reaches the kernel's launcher."""
    p, x, pe, kv, pk = _small_inputs()
    before = fc.launch_fused_conformer_group.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.launch_fused_conformer_group(p, x, pe, kv, pk, 0,
                                        torch.empty_like(x),
                                        torch.empty(3 * (5 * D + FF)),
                                        HEADS, HD)
    assert fc.launch_fused_conformer_group.launches == before


@pytest.mark.parametrize("n_tok,held", [(10, 10), (0, -3)],
                         ids=["wrap", "negative_is_0"])
def test_device_n_tok_matches_int_n_tok(n_tok, held):
    """The wrapper with ``n_tok`` held in a tensor (as the KV session's
    captured steps pass it) against the host int: identical outputs and
    rings, at a wrapping write and with a negative count clamped to 0."""
    p, x, pe, kv, pk = _small_inputs()
    kw = dict(heads=HEADS, head_dim=HD)
    kv_i, pk_i, kv_d, pk_d = kv.clone(), pk.clone(), kv.clone(), pk.clone()
    want = fc.fused_conformer_group(p, x, pe, kv_i, pk_i, n_tok, **kw)
    got = fc.fused_conformer_group(p, x, pe, kv_d, pk_d,
                                   torch.tensor([held], dtype=torch.int32),
                                   **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(kv_d, kv)
