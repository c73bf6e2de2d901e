"""The port's CUDA kernel on the card, against its plain PyTorch version.

Needs an NVIDIA GPU and nvcc.  It imports neither JAX nor the JAX package, so
it runs where they are not installed; skip the suite's conftest, which sets
JAX up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from moss_speech_decoder_cosy_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _qkv(shape, dtype, seed, qk_scale=0.3):
    rng = np.random.RandomState(seed)
    scales = (qk_scale, qk_scale, 1.0)
    return [torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
            .cuda().to(dtype) for s in scales]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,chunk,valid_len", [
    (2, 8, 1000, 0, 1000),     # offline decode
    (2, 8, 160, 50, 131),      # windowed decode, ragged valid_len
    (1, 2, 1, 0, 1),           # a single row
    (1, 3, 65, 0, 65),         # one row past a 64-row tile
    (2, 2, 130, 7, 100),       # a chunk that does not divide the tile
    (1, 2, 200, 100, 200),     # a chunk longer than the tile
    (1, 1, 300, 0, 5),         # nearly every key masked
    (1, 2, 16, 8, 13),         # one m16 tile, chunk 8
    (1, 2, 17, 16, 11),        # one row past an m16 tile, chunk 16
    (2, 3, 63, 8, 61),         # one row short of a 64-row tile
    (1, 2, 63, 16, 45),        # valid_len inside an n8 tile
    (1, 4, 1000, 16, 997),     # offline length, ragged valid_len
    (1, 2, 1000, 8, 555),      # chunk 8 over many key tiles
])
def test_kernel_matches_plain(card, dtype, b, h, t, chunk, valid_len):
    """Both entries against the plain version; one launch per call."""
    _check_both_entries(b, h, t, chunk, valid_len, dtype, qk_scale=0.3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,chunk,valid_len", [
    (2, 8, 1000, 0, 1000),
    (2, 8, 160, 50, 131),
])
def test_kernel_matches_plain_peaked(card, dtype, b, h, t, chunk, valid_len):
    """Scores with a spread of several units (q and k at scale 2): the row
    maxima move from tile to tile, so the online rescale and the bf16
    rounding of p carry real weight."""
    _check_both_entries(b, h, t, chunk, valid_len, dtype, qk_scale=2.0)


def _check_both_entries(b, h, t, chunk, valid_len, dtype, qk_scale):
    q, k, v = _qkv((b, h, t, 64), dtype, seed=t + chunk, qk_scale=qk_scale)
    want = fa.flash_chunk_attention_plain(q, k, v, chunk, valid_len)
    before = fa.launch_flash_chunk_attention.launches
    got = fa.flash_chunk_attention(q, k, v, chunk, valid_len)
    got_fl = fa.flash_chunk_attention_fl(
        *(x.transpose(1, 2).reshape(b, t, h * 64).contiguous()
          for x in (q, k, v)), heads=h, chunk_size=chunk,
        valid_len=valid_len).reshape(b, t, h, 64).transpose(1, 2)
    torch.cuda.synchronize()
    assert fa.launch_flash_chunk_attention.launches == before + 2
    tol = fa.kernel_tolerance(want)
    for out in (got, got_fl):
        assert out.dtype == dtype
        err = (out.float() - want.float()).abs().max().item()
        assert err <= tol, (err, tol)


def test_kernel_rejects_what_it_cannot_run(card):
    before = fa.launch_flash_chunk_attention.launches
    q = torch.zeros(1, 2, 16, 32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_chunk_attention(q, q, q)
    q = torch.zeros(1, 2, 16, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_chunk_attention(q, q, q)
    q = torch.zeros(1, 16, 2, 64, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_chunk_attention(q, q, q)
    assert fa.launch_flash_chunk_attention.launches == before


def test_flow_mel_on_card_matches_cpu(card):
    """A small flow model with 64-wide heads in f32: the kernel inside the
    whole model against the plain path on the CPU, offline and streaming,
    with one launch per transformer block per Euler step."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg = C.tiny_flow_config()
    est = dataclasses.replace(flow_cfg.estimator, attention_head_dim=64,
                              use_flash_attention=True)
    flow_cfg = dataclasses.replace(flow_cfg, estimator=est)
    hift_cfg = C.tiny_hift_config()
    states = seeded_states(flow_cfg, hift_cfg)
    tokens = np.random.RandomState(0).randint(0, flow_cfg.vocab_size,
                                              (1, 40))
    mels, launches = {}, {}
    for dev in ("cuda", "cpu"):
        dec = AudioDecoder(flow_cfg, hift_cfg, *states, device=dev)
        none = dec._defaults(None, None, None)
        fa.launch_flash_chunk_attention.launches = 0
        for streaming in (False, True):
            mels[dev, streaming] = dec._flow_mel(
                tokens, *none, streaming=streaming, finalize=True)
        launches[dev] = fa.launch_flash_chunk_attention.launches
    per_call = ((2 * len(est.channels) + est.num_mid_blocks) * est.n_blocks
                * flow_cfg.cfm.n_timesteps)
    assert launches == {"cuda": 2 * per_call, "cpu": 0}
    for streaming in (False, True):
        got, want = mels["cuda", streaming], mels["cpu", streaming]
        assert got.shape == want.shape == (1, 160, flow_cfg.output_size)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


# (L, rows, cf, cin, ch, heads, head_dim, rp, shared, offset, nd, enable)
GROUP_CASES = {
    "L1_prod_width_rampup": (1, 4, 20, 320, 256, 8, 64, 160, True, 40,
                             [20, 40, 60, 20], [1, 1, 1, 1]),
    "L4_prod_up_group_wrap": (4, 20, 20, 512, 256, 8, 64, 160, True, 152,
                              [172 + 20 * (i // 2) for i in range(20)],
                              [i % 3 != 0 for i in range(20)]),
    "rp70_not_tile_multiple_wrap": (2, 6, 10, 64, 32, 2, 16, 70, True, 65,
                                    [70, 15, 80, 100, 10, 35],
                                    [1, 1, 0, 1, 1, 1]),
    "per_row_offsets": (2, 8, 20, 256, 256, 8, 64, 160, False, 0,
                        [20, 45, 160, 171, 213, 300, 20, 99],
                        [1, 1, 1, 0, 1, 1, 0, 1]),
    "all_rows_disabled": (2, 4, 20, 256, 256, 8, 64, 160, True, 0,
                          [40, 40, 60, 60], [0, 0, 0, 0]),
    "tiny_chunk12_rp36": (1, 8, 12, 64, 24, 2, 8, 36, True, 32,
                          [12, 24, 36, 48, 12, 24, 36, 48],
                          [1, 1, 1, 1, 1, 0, 1, 1]),
    # more clusters than fit in one wave of the card
    "rows40_two_waves": (1, 40, 20, 256, 256, 8, 64, 160, True, 100,
                         [180] * 40, [1] * 40),
    # three heads dealt over a larger cluster, dk 16
    "heads3_dk16": (2, 6, 20, 64, 48, 3, 16, 80, True, 70,
                    [20, 40, 80, 100, 35, 90], [1, 1, 1, 0, 1, 1]),
    # ch 24: column slices narrower than an n8 tile, per-row offsets
    "ch24_narrow_slices": (2, 5, 16, 24, 24, 3, 8, 48, False, 0,
                           [16, 30, 48, 60, 100], [1, 1, 0, 1, 1]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_fused_tf_group_matches_plain(card, case, dtype):
    """The fused group kernel against its plain version at edge shapes:
    one and four layers, a ring not a multiple of the 64-slot tile, a
    wrapping shared write, per-row offsets, disabled rows.  Rows that are
    disabled keep their rings bit for bit, and no input is written."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    (n_layers, rows, cf, cin, ch, heads, hd, rp, shared, offset, nd,
     enable) = GROUP_CASES[case]
    p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
        rows, cf, cin, ch, heads, hd, n_layers, rp, dtype, card,
        seed=len(case))
    rot = [((r // 2) * cf) % rp for r in range(rows)]
    scal = fb.group_scalars(nd, rot, enable, card)
    inputs = [t.clone() for t in (mt, cc1, cc2, x, rings)]
    r_plain, r_kern = rings.clone(), rings.clone()
    want = fb.fused_tf_group_plain(p, rp_, mt, cc1, cc2, x, r_plain, scal,
                                   offset, heads=heads, head_dim=hd,
                                   shared_offset=shared)
    before = fb.launch_fused_tf_group.launches
    got = fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, r_kern, scal, offset,
                            heads=heads, head_dim=hd, shared_offset=shared)
    torch.cuda.synchronize()
    assert fb.launch_fused_tf_group.launches == before + 1
    assert got[1] is r_kern
    for g, w, what in zip(got, want, ("x", "rings", "cc1", "cc2")):
        assert g.dtype == dtype and g.shape == w.shape, what
        err = (g.float() - w.float()).abs().max().item()
        tol = fb.kernel_tolerance(w)
        assert err <= tol, (what, err, tol)
    off = torch.tensor(enable, device=card) == 0
    assert torch.equal(r_kern[:, off], rings[:, off])
    for before_t, after_t in zip(inputs, (mt, cc1, cc2, x, rings)):
        assert torch.equal(before_t, after_t)


# (L, C, D, heads, FF, Rt, n_tok)
CONFORMER_CASES = {
    "C1_rampup": (2, 1, 64, 2, 96, 8, 3),
    "C_is_Rt_wrap": (2, 8, 64, 2, 128, 8, 13),
    "n_tok0": (2, 5, 64, 4, 64, 12, 0),
    "wrap": (2, 6, 64, 2, 96, 10, 7),
    "ring_written_exactly_full": (2, 5, 64, 2, 96, 10, 5),
    "ragged_column_tiles": (2, 7, 24, 3, 40, 9, 4),
    # dk 12: in bf16 the second head's rows start 24 bytes into a row, so
    # its scores take the scalar path
    "head_off_16_bytes": (2, 7, 24, 2, 40, 9, 4),
    "more_slots_than_threads": (1, 4, 64, 1, 64, 300, 290),
    "blocks_group_full_width": (6, 5, 512, 8, 2048, 35, 100),
    "up_group_full_width_wrap": (4, 20, 512, 8, 2048, 140, 410),
    # two layers at full width: 96 of the 128 blocks have no item in
    # phases 3 and 5 and wait at the barrier
    "full_width_two_layers": (2, 5, 512, 8, 2048, 35, 35),
    # 256 column tiles in phases 1 and 4 over at most 132 blocks, so blocks
    # take several items a phase; three passes of 8 rows; W_2's K is 4096
    "wide_several_items_a_block": (2, 20, 1024, 16, 4096, 60, 75),
    # FF not a multiple of 16 columns: a ragged last tile in W_1
    "wide_ff_ragged_tile": (2, 9, 1024, 16, 3000, 40, 33),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CONFORMER_CASES))
def test_fused_conformer_group_matches_plain(card, case, dtype):
    """The conformer group kernel against its plain version at edge shapes:
    one-frame and ring-sized chunks, an empty ring, a wrapping write, a
    ring written exactly full, column tiles cut by D and FF, more ring
    slots than threads, and both full-width groups of the encoder.  Only the
    chunk's slots of the rings change, and no input is written."""
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    n_layers, c, d, heads, ff, rt, n_tok = CONFORMER_CASES[case]
    p, x, pe, kv, pk = fc.make_conformer_inputs(n_layers, c, d, heads, ff,
                                                rt, dtype, card,
                                                seed=len(case))
    hd = d // heads
    inputs = [t.clone() for t in (x, pe)]
    kv_plain, pk_plain = kv.clone(), pk.clone()
    kv_kern, pk_kern = kv.clone(), pk.clone()
    want = fc.fused_conformer_group_plain(p, x, pe, kv_plain, pk_plain,
                                          n_tok, heads=heads, head_dim=hd)
    before = fc.launch_fused_conformer_group.launches
    got = fc.fused_conformer_group(p, x, pe, kv_kern, pk_kern, n_tok,
                                   heads=heads, head_dim=hd)
    torch.cuda.synchronize()
    assert fc.launch_fused_conformer_group.launches == before + 1
    assert got[1] is kv_kern and got[2] is pk_kern
    for g, w, what in zip(got, want, ("x", "ring_kv", "ring_pk")):
        assert g.dtype == dtype and g.shape == w.shape, what
        err = (g.float() - w.float()).abs().max().item()
        tol = fc.kernel_tolerance(w)
        assert err <= tol, (what, err, tol)
    written = {(n_tok + f) % rt for f in range(c)}
    kept = [s for s in range(rt) if s not in written]
    assert torch.equal(kv_kern[:, :, kept], kv[:, :, kept])
    assert torch.equal(pk_kern[:, :, kept], pk[:, :, kept])
    for before_t, after_t in zip(inputs, (x, pe)):
        assert torch.equal(before_t, after_t)


def test_conformer_smem_limit_matches_the_launcher(card):
    """``fused_conformer.kernel_smem_bytes`` (the Python copy of the
    launcher's layout) against the compiled entry over widths and rings in
    both dtypes: the same bytes, and the entry refuses exactly the shapes
    the wrapper refuses, so the KV session never meets a bare CUDA error
    there.  The full-width groups fit one block an SM."""
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        for d, heads, ff in ((512, 8, 2048), (512, 8, 6984), (512, 8, 6992),
                             (1024, 16, 4096), (64, 2, 7304), (24, 3, 40)):
            for c, rt in ((5, 35), (20, 140), (1, 3000)):
                want = fc.kernel_smem_bytes(c, d, d // heads, ff, rt)
                rc, grid, smem = fc.launch_config(c, d, heads, d // heads,
                                                  ff, 2, rt, dtype)
                assert smem == want, (dtype, d, ff, c, rt)
                fits = want <= 232448
                assert (rc == 0) == fits and (grid > 0) == fits
                seen.add(fits)
    assert seen == {True, False}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c, rt, items in ((5, 35, 128), (20, 140, 160)):
        rc, grid, _ = fc.launch_config(c, 512, 8, 64, 2048, 4, rt,
                                       torch.bfloat16)
        assert rc == 0 and grid == min(items, sms)
    p, x, pe, kv, pk = fc.make_conformer_inputs(1, 1, 512, 8, 6992, 1,
                                                torch.bfloat16, card)
    before = fc.launch_fused_conformer_group.launches
    with pytest.raises(ValueError, match="shared memory"):
        fc.fused_conformer_group(p, x, pe, kv, pk, 0, heads=8, head_dim=64)
    assert fc.launch_fused_conformer_group.launches == before


def test_fused_conformer_group_rejects_what_it_cannot_run(card):
    """Mixed CPU / CUDA inputs and a chunk longer than the ring raise before
    any launch."""
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    p, x, pe, kv, pk = fc.make_conformer_inputs(2, 5, 64, 2, 96, 10,
                                                torch.float32, card)
    before = fc.launch_fused_conformer_group.launches
    with pytest.raises(ValueError, match="ring_pk lies on cpu"):
        fc.fused_conformer_group(p, x, pe, kv, pk.cpu(), 0, heads=2,
                                 head_dim=32)
    with pytest.raises(ValueError, match="lies on"):
        fc.fused_conformer_group(dict(p, w1k=p["w1k"].cpu()), x, pe, kv, pk,
                                 0, heads=2, head_dim=32)
    p, x, pe, kv, pk = fc.make_conformer_inputs(2, 12, 64, 2, 96, 10,
                                                torch.float32, card)
    with pytest.raises(ValueError, match="chunk 12 must be in"):
        fc.fused_conformer_group(p, x, pe, kv, pk, 0, heads=2, head_dim=32)
    assert fc.launch_fused_conformer_group.launches == before


def test_enc_kernel_wavefront_on_card_matches_cpu(card):
    """The tiny KV session's wavefront in f32 with the kernel encoder hop:
    the card (both kernels) against the CPU (plain versions), two conformer
    launches per steady hop."""
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
    states = seeded_states(flow_cfg, hift_cfg)
    tokens = np.random.RandomState(3).randint(0, flow_cfg.vocab_size,
                                              (1, 30))
    mels, launches = {}, {}
    for dev in ("cuda", "cpu"):
        dec = AudioDecoder(flow_cfg, hift_cfg, *states,
                           C.PipelineConfig(block_size=3, mel_cache_len=2,
                                            max_token_len=9), device=dev)
        kv = dec.kv_stream_decoder(ring_tokens=6, token_cap=64,
                                   enc_kernel=True)
        cache, _ = kv.init_state()
        plan = kv.schedule(tokens.shape[1])
        fc.launch_fused_conformer_group.launches = 0
        mel, _ = kv._flow_mels_wave(kv._token_buf(tokens), cache, plan)
        launches[dev] = fc.launch_fused_conformer_group.launches
        mels[dev] = mel.float().cpu().numpy()
    k = sum(1 for _, fin in plan if not fin)
    assert launches == {"cuda": 2 * k, "cpu": 0}
    assert mels["cuda"].shape == mels["cpu"].shape == (
        1, 30 * flow_cfg.token_mel_ratio, flow_cfg.output_size)
    np.testing.assert_allclose(mels["cuda"], mels["cpu"], atol=1e-4, rtol=0)


def test_kernel_limit_matches_the_launchers_cluster_choice(card):
    """``fused_block.cluster_size`` (the Python copy of the launcher's
    shared-memory layout) against the compiled entry's choice over rings
    and dtypes at the MOSS estimator's widths, hop 5, every group's cin."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        for ring in range(5, 125, 5):
            for cin in (320, 256, 512):
                geometry = (20, 4 * ring + 20, cin, 256, 1024, 1024, 8, 64,
                            dtype)
                want = fb.cluster_size(*geometry)
                assert fb.kernel_cluster(*geometry) == want, geometry
                assert (fb.kernel_limit(*geometry) is None) == (want > 0)
                seen.add(want)
    assert seen == {0, 4, 8}


DEVICE_SCALAR_CASES = {"group_wrap": 150, "group_offset0": 0,
                       "group_offset_past_rp": 160 + 37}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(DEVICE_SCALAR_CASES))
def test_fused_tf_group_device_offset_matches_plain(card, case, dtype):
    """The group kernel reading its shared write offset from device memory
    (an int32 on the card, as the KV session passes it) against the plain
    version at the same offset (taken modulo rp), at a wrapping write."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    rows, cf, rp = 8, 20, 160
    offset = DEVICE_SCALAR_CASES[case]
    p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
        rows, cf, 256, 256, 8, 64, 2, rp, dtype, card, seed=offset)
    scal = fb.group_scalars([180 - 20 * (r // 2) for r in range(rows)],
                            [((r // 2) * cf) % rp for r in range(rows)],
                            [r != 5 for r in range(rows)], card)
    r_plain, r_kern = rings.clone(), rings.clone()
    kw = dict(heads=8, head_dim=64)
    want = fb.fused_tf_group_plain(p, rp_, mt, cc1, cc2, x, r_plain, scal,
                                   offset % rp, **kw)
    held = torch.tensor([offset], dtype=torch.int32, device=card)
    before = fb.launch_fused_tf_group.launches
    got = fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, r_kern, scal, held, **kw)
    torch.cuda.synchronize()
    assert fb.launch_fused_tf_group.launches == before + 1
    for g, w, what in zip(got, want, ("x", "rings", "cc1", "cc2")):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= fb.kernel_tolerance(w), (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_tok", [0, 37, 140 + 135, -4],
                         ids=["empty", "rampup", "wrap", "negative_is_0"])
def test_fused_conformer_group_device_n_tok_matches_plain(card, n_tok,
                                                          dtype):
    """The conformer kernel reading n_tok from device memory against the
    plain version with the same device n_tok and with the host int (a
    negative count is 0)."""
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    p, x, pe, kv, pk = fc.make_conformer_inputs(4, 20, 512, 8, 2048, 140,
                                                dtype, card, seed=n_tok + 9)
    kv_p, pk_p, kv_k, pk_k = kv.clone(), pk.clone(), kv.clone(), pk.clone()
    kw = dict(heads=8, head_dim=64)
    want = fc.fused_conformer_group_plain(p, x, pe, kv_p, pk_p, max(n_tok, 0),
                                          **kw)
    held = torch.tensor([n_tok], dtype=torch.int32, device=card)
    got = fc.fused_conformer_group(p, x, pe, kv_k, pk_k, held, **kw)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("x", "ring_kv", "ring_pk")):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= fc.kernel_tolerance(w), (what, err)


def test_captured_kernels_read_each_replays_scalars(card):
    """Both kernels captured once in a CUDA graph with their scalars in
    device memory, then replayed after the scalars changed: each replay
    matches the plain version at the new value (a host int baked into the
    launch would replay the first one)."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    rows, cf, rp = 4, 20, 160
    p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
        rows, cf, 256, 256, 8, 64, 1, rp, torch.float32, card, seed=1)
    scal = fb.group_scalars([rp + cf] * rows, [0] * rows, [1] * rows, card)
    cp, cx, cpe, ckv, cpk = fc.make_conformer_inputs(
        2, 5, 512, 8, 2048, 35, torch.float32, card, seed=2)
    offset = torch.zeros(1, dtype=torch.int32, device=card)
    n_tok = torch.zeros(1, dtype=torch.int32, device=card)
    g_rings, g_kv, g_pk = rings.clone(), ckv.clone(), cpk.clone()
    kw = dict(heads=8, head_dim=64)

    def step():
        return (fb.fused_tf_group(p, rp_, mt, cc1, cc2, x, g_rings, scal,
                                  offset, **kw)[0],
                fc.fused_conformer_group(cp, cx, cpe, g_kv, g_pk, n_tok,
                                         **kw)[0])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                       # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for off, nt in ((100, 7), (150, 60), (13, 33)):
        offset.fill_(off)
        n_tok.fill_(nt)
        r_plain, kv_plain, pk_plain = g_rings.clone(), g_kv.clone(), \
            g_pk.clone()
        want = (fb.fused_tf_group_plain(p, rp_, mt, cc1, cc2, x, r_plain,
                                        scal, off, **kw)[0],
                fc.fused_conformer_group_plain(cp, cx, cpe, kv_plain,
                                               pk_plain, nt, **kw)[0])
        graph.replay()
        torch.cuda.synchronize()
        for g, w, got_ring, want_ring in zip(outs, want, (g_rings, g_kv),
                                             (r_plain, kv_plain)):
            assert (g - w).abs().max().item() <= 2e-5, (off, nt)
            assert (got_ring - want_ring).abs().max().item() <= 2e-5


def _tiny_kv_sessions(device, enc_kernel, **kw):
    """The tiny f32 KV session (block 3, ring 6) on ``device``, graphed
    (the default) and eager."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
    dec = AudioDecoder(flow_cfg, hift_cfg, *seeded_states(flow_cfg, hift_cfg),
                       C.PipelineConfig(block_size=3, mel_cache_len=2,
                                        max_token_len=9), device=device)
    return [dec.kv_stream_decoder(ring_tokens=6, token_cap=64,
                                  enc_kernel=enc_kernel, graphs=graphs, **kw)
            for graphs in (True, False)]


@pytest.mark.parametrize("enc_kernel", [False, True],
                         ids=["per_layer_encoder", "enc_kernel"])
def test_graphed_steps_match_eager(card, enc_kernel):
    """The wavefront (both iteration variants, graphed) and the per-hop
    step (the first hop and the finalize tail, graphed) against the same
    device-scalar steps run eagerly, f32 on the card, twice each so the
    second pass replays every graph; exact fused-kernel launch counts."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    graphed, eager = _tiny_kv_sessions(card, enc_kernel)
    tokens = np.random.RandomState(5).randint(
        0, graphed.dec.flow_cfg.vocab_size, (1, 30))
    assert graphed._graphs and not eager._graphs
    plan = graphed.schedule(tokens.shape[1])
    k = sum(1 for _, fin in plan if not fin)
    want_launches = ((k + graphed.s_steps - 1) * 3, 2 * k if enc_kernel else 0)
    mels = {}
    for sess in (graphed, eager):
        for rep in range(2):
            cache, _ = sess.init_state()
            buf = sess._token_buf(tokens)
            fb.launch_fused_tf_group.launches = 0
            fc.launch_fused_conformer_group.launches = 0
            mel, _ = sess._flow_mels_wave(buf, cache, plan)
            assert (fb.launch_fused_tf_group.launches,
                    fc.launch_fused_conformer_group.launches) == want_launches
            cache, _ = sess.init_state()
            hops = torch.cat([sess._hop(buf, cache, e, f)[0]
                              for e, f in plan], dim=1)
            mels[sess._graphs, rep] = (mel.cpu().numpy(), hops.cpu().numpy())
    assert {("wave", True), ("wave", False)} <= set(graphed._graph)
    for rep in range(2):
        for got, want in zip(mels[True, rep], mels[False, rep]):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for got, want in zip(mels[True, 1], mels[True, 0]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("enc_kernel", [False, True],
                         ids=["per_layer_encoder", "enc_kernel"])
def test_profiler_counts_the_graphed_kernels(card, enc_kernel):
    """One graphed ``stream_decode`` (every graph already captured) under
    torch.profiler: the fused kernels the card ran equal the launch
    counters the session added at each replay.  The trace comes from
    ``utils.graphs.profiled``: CUPTI set up before this module captured a
    graph, and the decode inside the traced part of the window (the first
    milliseconds of a trace go unrecorded: a lead-in of marker kernels
    comes first, and markers traced on both sides of the decode prove
    it)."""
    from torch.autograd import DeviceType
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    from moss_speech_decoder_cosy_torch.utils.graphs import profiled
    sess = _tiny_kv_sessions(card, enc_kernel)[0]
    tokens = np.random.RandomState(6).randint(
        0, sess.dec.flow_cfg.vocab_size, (1, 30))
    sess.stream_decode(tokens)                      # captures every graph
    torch.cuda.synchronize()
    fb.launch_fused_tf_group.launches = 0
    fc.launch_fused_conformer_group.launches = 0
    prof, _, edges = profiled(lambda: sess.stream_decode(tokens))
    assert all(edges), "a kernel of the decode may lie outside the trace"
    ran = {"fused_tf_group_kernel": 0, "fused_conformer_group_kernel": 0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in ran:
                if name in e.name:
                    ran[name] += 1
    counted = (fb.launch_fused_tf_group.launches,
               fc.launch_fused_conformer_group.launches)
    assert counted[0] > 0 and (counted[1] > 0) == enc_kernel
    assert (ran["fused_tf_group_kernel"],
            ran["fused_conformer_group_kernel"]) == counted


def _tiny_batcher_decoder(device):
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
    return AudioDecoder(flow_cfg, hift_cfg, *seeded_states(flow_cfg, hift_cfg),
                        C.PipelineConfig(block_size=3, mel_cache_len=2,
                                         max_token_len=9), device=device)


def _serve_staggered(b, seed):
    """Three streams through a 2-lane batcher: the second admitted mid-stream
    of the first, the third into the lane the first freed.  Returns the
    wavs and the ticks run."""
    rng = np.random.RandomState(seed)
    cfg = b.dec.flow_cfg
    streams = [(rng.randint(0, cfg.vocab_size, (1, p)),
                rng.randn(1, p * cfg.token_mel_ratio,
                          cfg.output_size).astype(np.float32),
                rng.randn(1, cfg.spk_embed_dim).astype(np.float32),
                rng.randint(0, cfg.vocab_size, (1, n)))
               for p, n in ((2, 25), (0, 16), (3, 13))]
    chunks, ticks0 = {}, b.ticks

    def pump_until_free(lanes):
        for _ in range(100):
            for lane, wav in b.pump(max_iters=4).items():
                chunks.setdefault(owner[lane], []).append(wav)
            if not any(b._lanes[lane].active for lane in lanes):
                return
        raise AssertionError("lanes never drained")

    owner = {}
    la = b.admit(*streams[0][:3])
    owner[la] = 0
    b.push(la, streams[0][3][:, :10])
    for lane, wav in b.pump(max_iters=4).items():
        chunks.setdefault(owner[lane], []).append(wav)
    lb = b.admit(*streams[1][:3])
    owner[lb] = 1
    b.push(lb, streams[1][3])
    b.push(la, streams[0][3][:, 10:])
    b.finish(la)
    b.finish(lb)
    pump_until_free([la])
    lc = b.admit(*streams[2][:3])
    assert lc == la
    owner[lc] = 2
    b.push(lc, streams[2][3])
    b.finish(lc)
    pump_until_free([lb, lc])
    return ([np.concatenate(chunks[i], axis=1) for i in range(3)],
            b.ticks - ticks0)


def test_lanes_kernel_engine_matches_plain_engine_on_card(card):
    """The batcher's kernel engine (``fused_tf_group`` in its per-row write
    mode) against its unfused engine, f32 on the card, same protocol."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    dec = _tiny_batcher_decoder(card)
    wavs = {}
    for kernel in (True, False):
        b = dec.kv_batcher(n_lanes=2, ring_tokens=6, token_cap=64,
                           kernel=kernel)
        assert b._kernel is kernel and b._graphs
        fb.launch_fused_tf_group.launches = 0
        wavs[kernel], ticks = _serve_staggered(b, 8)
        assert fb.launch_fused_tf_group.launches == (3 * ticks if kernel
                                                     else 0)
    for got, want in zip(wavs[True], wavs[False]):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_graphed_batcher_matches_eager(card):
    """The graphed batcher (tick, encoder hop, steady vocoder hop and
    finalize hop replayed) against the same steps run eagerly, f32 on the
    card, twice each so the second pass replays every graph."""
    dec = _tiny_batcher_decoder(card)
    graphed, eager = (dec.kv_batcher(n_lanes=2, ring_tokens=6, token_cap=64,
                                     graphs=g) for g in (True, False))
    assert graphed._graphs and not eager._graphs and graphed._kernel
    runs = {(b._graphs, rep): _serve_staggered(b, 9)[0]
            for b in (graphed, eager) for rep in range(2)}
    keys = set(graphed._steps.graphs)
    assert {("tick",), ("enc",), ("voc",)} <= keys
    assert {k for k in keys if k[0] == "fin"}        # one per tail length
    for rep in range(2):
        for got, want in zip(runs[True, rep], runs[False, rep]):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for got, want in zip(runs[True, 1], runs[True, 0]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("graphs", [True, False], ids=["graphed", "eager"])
def test_batcher_launches_fused_tf_group_per_tick(card, monkeypatch, graphs):
    """Every tick of the kernel engine launches ``fused_tf_group`` once per
    resnet + transformer group (down, mid, up), in its per-row write mode,
    and nothing else of the batcher launches it."""
    from moss_speech_decoder_cosy_torch.models.flow import kv_stream
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    dec = _tiny_batcher_decoder(card)
    b = dec.kv_batcher(n_lanes=2, ring_tokens=6, token_cap=64,
                       graphs=graphs)
    modes = []

    def spy(*args, **kw):
        modes.append(kw["shared_offset"])
        return fb.fused_tf_group(*args, **kw)
    monkeypatch.setattr(kv_stream, "fused_tf_group", spy)
    fb.launch_fused_tf_group.launches = 0
    _, ticks = _serve_staggered(b, 10)
    e = dec.flow_cfg.estimator
    assert ticks > 0
    assert fb.launch_fused_tf_group.launches == (2 + e.num_mid_blocks) * ticks
    assert modes and not any(modes)         # every traced call per-row


def test_audio_batch_engine_on_card(card):
    """Two concurrent asyncio clients through ``AudioBatchEngine`` on the
    card (the batcher's graphs captured and replayed from the engine's
    executor threads) get the audio the same streams give one after the
    other through the same engine."""
    import asyncio
    from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
        AudioBatchEngine)
    dec = _tiny_batcher_decoder(card)
    rng = np.random.RandomState(12)
    cfg = dec.flow_cfg
    streams = [(rng.randn(1, cfg.spk_embed_dim).astype(np.float32),
                rng.randint(0, cfg.vocab_size, (1, n))) for n in (19, 14)]

    async def client(engine, emb, toks, pieces):
        s = await engine.open(embedding=emb)
        for part in np.array_split(toks, pieces, axis=1):
            await s.push(part)
            await asyncio.sleep(0.003)
        await s.finish()
        return np.concatenate([c async for c in s], axis=1)

    async def run(concurrent):
        engine = AudioBatchEngine(dec, n_lanes=2, ring_tokens=6,
                                  token_cap=64)
        assert engine.batcher._graphs
        if concurrent:
            return await asyncio.gather(*[
                client(engine, *st, pieces=3 + i)
                for i, st in enumerate(streams)])
        return [await client(engine, *st, pieces=1) for st in streams]

    together, apart = asyncio.run(run(True)), asyncio.run(run(False))
    for got, want in zip(together, apart):
        assert got.shape == want.shape and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _cpu_draws(harmonics, length, device):
    """NSF draws made on the CPU from seed 0, the same on every device, so
    the card's audio can be held against the CPU's."""
    gen = torch.Generator().manual_seed(0)
    return (torch.rand((1, harmonics), generator=gen).to(device),
            torch.randn((1, length, harmonics), generator=gen).to(device))


def _tiny_windowed_decoder(device):
    """The tiny seeded models with a louder vocoder head (``conv_post``'s
    gain x 100: peak ~0.12 instead of ~0.001), so that the wav tolerances
    are small beside a typical sample."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
    flow_state, hift_state = seeded_states(flow_cfg, hift_cfg)
    hift_state = dict(hift_state, **{
        "conv_post.g": hift_state["conv_post.g"] * 100.0})
    return AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                        C.PipelineConfig(block_size=4, mel_cache_len=6,
                                         max_token_len=16), device=device,
                        nsf_draws=_cpu_draws)


def _windowed_tokens(dec, n, batch, seed):
    return np.random.RandomState(seed).randint(
        0, dec.flow_cfg.vocab_size, (batch, n))


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("batch", [1, 2], ids=["batch1", "batch2"])
def test_graphed_device_session_matches_eager(card, batch, fused):
    """The windowed device session with every step replayed as a CUDA graph
    (the buckets' batched flow forward at batch 1, the flow scans at batch
    2, the vocoder scans, the first, steady and finalize hops) against the
    same steps run eagerly, f32 on the card, twice each so the second pass
    replays every graph."""
    dec = _tiny_windowed_decoder(card)
    graphed, eager = (dec.device_stream_decoder(batch=batch, graphs=g)
                      for g in (True, False))
    assert graphed._graphs and not eager._graphs
    tokens = _windowed_tokens(dec, 40, batch, seed=20)
    wavs = {(s._graphs, rep): s.stream_decode(tokens, fused=fused)
            for s in (graphed, eager) for rep in range(2)}
    assert set(graphed._steps.graphs) == set(graphed.dispatches(40, fused))
    assert np.abs(wavs[False, 0]).max() > 0.05
    for rep in range(2):
        np.testing.assert_allclose(wavs[True, rep], wavs[False, rep],
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(wavs[True, 1], wavs[True, 0])


@pytest.mark.parametrize("batch", [1, 2], ids=["buckets", "scan"])
def test_device_session_on_card_matches_cpu(card, batch):
    """40 tokens through the graphed device session on the card against the
    CPU, f32, the NSF draws the same on both: batch 1 runs two buckets of 4
    windows as batched flow forwards, batch 2 as flow scans."""
    wavs = {}
    for dev in ("cuda", "cpu"):
        dec = _tiny_windowed_decoder(dev)
        sess = dec.device_stream_decoder(batch=batch)
        keys = sess.dispatches(40)
        assert keys.count(("fbatch" if batch == 1 else "fscan", 4, 4)) == 2
        wavs[dev] = sess.stream_decode(_windowed_tokens(dec, 40, batch, 21))
        assert sess._graphs == (dev == "cuda")
    assert wavs["cuda"].shape == wavs["cpu"].shape == (
        batch, 40 * dec.ratio * dec.hift_cfg.total_upsample)
    assert np.abs(wavs["cpu"]).max() > 0.05
    np.testing.assert_allclose(wavs["cuda"], wavs["cpu"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_device_session_replays_without_host_sync(card, fused):
    """After one warm-up decode the session holds one graph per distinct
    step key of the plan, and a decode enqueues every step (and the token
    upload) with no host synchronisation until the final copy."""
    dec = _tiny_windowed_decoder(card)
    sess = dec.device_stream_decoder()
    tokens = _windowed_tokens(dec, 40, 1, seed=22)
    want = sess.stream_decode(tokens, fused=fused)
    keys = sess.dispatches(40, fused)
    assert len(sess._steps.graphs) == len(set(keys)) < len(keys)
    torch.cuda.set_sync_debug_mode("error")
    try:
        wav = sess._decode_device(tokens, fused)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(sess._steps.graphs) == len(set(keys))
    np.testing.assert_array_equal(wav.cpu().numpy(), want)


# ------------------------------------------- the KV session's API (A4, A13)
def _pcm16_np(wav):
    from moss_speech_decoder_cosy_torch.pipeline.kv_session import _pcm16
    return _pcm16(torch.from_numpy(wav)).numpy()


def test_kv_int16_and_segmented_streams_on_card(card):
    """Graphed, f32: ``output="int16"`` is ``_pcm16`` of the f32 stream; the
    segmented decode (3 iterations a segment) and ``stream_chunks(
    wavefront=True)`` give the unsegmented stream bit for bit (the bulk
    vocoder runs every batch of hop windows at one shape), in f32 and in
    int16."""
    kv = _tiny_kv_sessions(card, False)[0]
    tokens = np.random.RandomState(7).randint(
        0, kv.dec.flow_cfg.vocab_size, (1, 30))
    f32 = kv.stream_decode(tokens)
    i16 = kv.stream_decode(tokens, output="int16")
    np.testing.assert_array_equal(i16, _pcm16_np(f32))
    np.testing.assert_array_equal(
        kv.stream_decode(tokens, segmented=True, seg_iters=3), f32)
    np.testing.assert_array_equal(
        kv.stream_decode(tokens, output="int16", segmented=True,
                         seg_iters=3), i16)
    chunks = list(kv.stream_chunks(tokens, wavefront=True, seg_iters=4))
    assert len(chunks) >= 2
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), f32)


def test_kv_segments_enqueue_without_host_sync(card):
    """A segmented decode's segments (wavefront replays, the finalize hop
    and each segment's bulk vocode) read nothing back to the host."""
    kv = _tiny_kv_sessions(card, False)[0]
    tokens = np.random.RandomState(8).randint(
        0, kv.dec.flow_cfg.vocab_size, (1, 30))
    want = kv.stream_decode(tokens, segmented=True, seg_iters=3)
    with torch.inference_mode():
        buf, cache, _, plan = kv._start(tokens)
        k = sum(1 for _, fin in plan if not fin)
        sizes = kv._seg_sizes(k + kv.s_steps - 1, 3)
        torch.cuda.set_sync_debug_mode("error")
        try:
            wavs = list(kv._segment_wavs(buf, cache, plan, sizes))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    got = torch.cat(wavs, dim=1).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(fused=False),
                                dict(write_mode="onehot"),
                                dict(ring_tokens=7)],
                         ids=["concat", "onehot", "ring_7"])
def test_graphed_dataflow_options_match_eager(card, kw):
    """The concat dataflow and the one-hot fused write (also at a ring that
    is not a multiple of the hop), graphed against eager, f32, twice so the
    second pass replays every graph."""
    kw = dict(dict(ring_tokens=6), **kw)
    ring = kw.pop("ring_tokens")
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states
    flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
    dec = AudioDecoder(flow_cfg, hift_cfg, *seeded_states(flow_cfg, hift_cfg),
                       C.PipelineConfig(block_size=3, mel_cache_len=2,
                                        max_token_len=9), device=card)
    graphed, eager = [dec.kv_stream_decoder(ring_tokens=ring, token_cap=64,
                                            graphs=g, **kw)
                      for g in (True, False)]
    assert not graphed._kernel and graphed._graphs
    tokens = np.random.RandomState(9).randint(0, flow_cfg.vocab_size,
                                              (1, 30))
    wavs = [[s.stream_decode(tokens) for _ in range(2)]
            for s in (graphed, eager)]
    assert ("wave", True) in graphed._graph
    np.testing.assert_array_equal(wavs[0][1], wavs[0][0])
    np.testing.assert_allclose(wavs[0][1], wavs[1][0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("enc_kernel", [False, True],
                         ids=["per_layer_encoder", "enc_kernel"])
def test_program_flops_same_on_card_and_cpu(card, enc_kernel):
    """The kernels count their analytic FLOPs on the card (a ctypes launch)
    and on the CPU (their plain versions), so a session counts the same
    FLOPs on both."""
    got = _tiny_kv_sessions(card, enc_kernel)[0].program_flops(30)
    want = _tiny_kv_sessions(torch.device("cpu"),
                             enc_kernel)[0].program_flops(30)
    assert got == want > 0


@pytest.mark.parametrize("kw", [dict(batch=2), dict(ring_quant=True),
                                dict(batch=2, ring_quant=True)],
                         ids=["lockstep", "int8", "int8_lockstep"])
def test_graphed_lockstep_and_int8_sessions_match_eager(card, kw):
    """Lockstep streams (the kernel engine at 2 * B * S rows, one
    fused_tf_group launch a group as at batch 1) and int8 rings (the
    unfused concat engine, no kernel), graphed against eager on the card,
    f32, twice so the second pass replays every graph: equal."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    graphed, eager = _tiny_kv_sessions(card, False, **kw)
    b = kw.get("batch", 1)
    assert graphed.b == b and graphed._kernel is not kw.get("ring_quant",
                                                            False)
    tokens = np.random.RandomState(12).randint(
        0, graphed.dec.flow_cfg.vocab_size, (b, 30))
    k = sum(1 for _, fin in graphed.schedule(30) if not fin)
    wavs = {}
    for sess in (graphed, eager):
        for rep in range(2):
            fb.launch_fused_tf_group.launches = 0
            wavs[sess._graphs, rep] = sess.stream_decode(tokens)
            assert fb.launch_fused_tf_group.launches == (
                0 if kw.get("ring_quant") else (k + sess.s_steps - 1) * 3)
    assert wavs[True, 0].shape[0] == b and ("wave", True) in graphed._graph
    np.testing.assert_array_equal(wavs[True, 1], wavs[True, 0])
    np.testing.assert_array_equal(wavs[True, 0], wavs[False, 0])
    if b > 1:
        assert np.abs(wavs[True, 0][0] - wavs[True, 0][1]).max() > 0


def test_tokenizer_step_on_card_matches_cpu(card):
    """The tiny WhisperVQ encoder's streaming step on the card (f32, no
    host sync inside a step: the position is a device scalar) against the
    same step on the CPU: pooled features within 1e-5, tokens equal; and
    the batch forward on the card equal to its stream."""
    from moss_speech_decoder_cosy_torch.tokenizer import (
        WhisperVQEncoder, tiny_tokenizer_config)
    from moss_speech_decoder_cosy_torch.weights import seeded_state
    cfg = tiny_tokenizer_config()
    with torch.device("meta"):
        meta = WhisperVQEncoder(cfg)
    state = seeded_state(meta, 3)
    models = {}
    for dev in ("cpu", "cuda"):
        with torch.device("meta"):
            m = WhisperVQEncoder(cfg)
        m.load_state_dict(state, strict=True, assign=True)
        models[dev] = m.to(dev).eval()
    mel = torch.from_numpy(np.random.RandomState(13).randn(
        1, 40, cfg.num_mel_bins).astype(np.float32))
    out = {}
    with torch.inference_mode():
        for dev, m in models.items():
            st = m.init_state(1)
            steps = []
            for i in range(0, 40, 8):
                chunk = mel[:, i:i + 8].to(dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    steps.append(m.step_features(chunk, st))
                finally:
                    if dev == "cuda":
                        torch.cuda.set_sync_debug_mode("default")
            out[dev] = [torch.cat([s[j] for s in steps], 1).cpu().numpy()
                        for j in range(2)]
        bids, _, bpooled = models["cuda"].encode(
            mel.cuda(), torch.ones((1, 40), dtype=torch.bool, device="cuda"))
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(bids.cpu().numpy(), out["cuda"][0])
    np.testing.assert_allclose(bpooled.cpu().numpy(), out["cuda"][1],
                               atol=1e-5, rtol=0)


def _graph_ids(b):
    return {k: id(g) for k, (g, _) in b._steps.graphs.items()}


def test_boot_warmup_batcher_then_no_new_capture(card):
    """``serving/boot.boot_warmup_batcher`` captures every graph the
    batcher serves with: requests after it (with the warmed prompt
    geometry, promptless, every tail length) replay the same graphs and
    capture none (the card's counterpart of the JAX package's no-new-
    compiles test)."""
    from moss_speech_decoder_cosy_torch.serving.boot import (
        boot_warmup_batcher)
    dec = _tiny_batcher_decoder(card)
    cfg = dec.flow_cfg
    b = dec.kv_batcher(n_lanes=2, ring_tokens=6, token_cap=64)
    prompt = dataclasses.make_dataclass("P", ["token", "feat", "embedding"])(
        np.arange(3, dtype=np.int32)[None] % cfg.vocab_size,
        np.zeros((1, 3 * cfg.token_mel_ratio, cfg.output_size), np.float32),
        np.zeros((1, cfg.spk_embed_dim), np.float32))
    boot_warmup_batcher(b, prompt=prompt, verbose=False)
    before = _graph_ids(b)
    captures = dict(b._steps.captures)
    assert set(captures) == set(before)
    assert {("tick",), ("enc",), ("voc",)} <= set(before)
    assert len([k for k in before if k[0] == "fin"]) == b.hop
    rng = np.random.RandomState(1)
    for use_prompt, n in ((True, 12), (False, 9), (True, 10), (False, 14)):
        if use_prompt:
            lane = b.admit(prompt.token, prompt.feat, prompt.embedding)
        else:
            lane = b.admit(np.zeros((1, 0), np.int32),
                           np.zeros((1, 0, cfg.output_size), np.float32),
                           np.zeros((1, cfg.spk_embed_dim), np.float32))
        b.push(lane, rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int32))
        b.finish(lane)
        got = 0
        while b._lanes[lane].active:
            got += sum(v.shape[1] for v in b.pump(max_iters=8).values())
        assert got > 0
    assert _graph_ids(b) == before and dict(b._steps.captures) == captures
    assert b._steps.replays[("tick",)] > 0


# the batched steady vocoder hop against lane-by-lane hops in bf16: eight
# bf16 ulps of the peak (2 ** -5); the two differ only where a convolution
# rounds differently at another batch
BF16_LANES_TOL = 2.0 ** -5


def test_batched_vocoder_hop_matches_per_lane_bf16(card):
    """bf16 lanes on the card, graphed: three staggered streams (the second
    admitted after the first pump, the third after the second), each
    lane's audio from the batched steady vocoder hop against the same
    chunks' mels vocoded lane by lane with ``vocode_hop`` at batch 1,
    within ``BF16_LANES_TOL`` of the peak."""
    from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder
    from moss_speech_decoder_cosy_torch.pipeline.kv_session import (
        vocode_hop)
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg, hift_cfg = C.tiny_flow_config(), C.tiny_hift_config()
    flow_state, hift_state = seeded_states(flow_cfg, hift_cfg)
    hift_state = dict(hift_state, **{
        "conv_post.g": hift_state["conv_post.g"] * 100.0})
    dec = AudioDecoder(flow_cfg, hift_cfg, flow_state, hift_state,
                       C.PipelineConfig(block_size=3, mel_cache_len=2,
                                        max_token_len=9),
                       compute_dtype=torch.bfloat16, device=card)
    b = dec.kv_batcher(n_lanes=3, ring_tokens=6, token_cap=64)
    assert b._graphs and b.dt == torch.bfloat16
    hops, fin_lane = {}, [None]
    emit, vocode, finalize = b._emit, b._vocode, b._finalize_lane

    def rec_emit(lane, st, mel):
        hops.setdefault(lane, []).append(
            ("first" if st.first_voc else "steady", mel.clone()))
        return emit(lane, st, mel)

    def rec_finalize(lane, st):
        fin_lane[0] = lane
        return finalize(lane, st)

    def rec_vocode(mel, voc, first, fin, draws=None):
        if fin:
            hops[fin_lane[0]].append(("fin", mel.clone()))
        return vocode(mel, voc, first, fin, draws)

    b._emit, b._finalize_lane, b._vocode = rec_emit, rec_finalize, rec_vocode
    rng = np.random.RandomState(13)
    streams = [(rng.randn(1, flow_cfg.spk_embed_dim).astype(np.float32),
                rng.randint(0, flow_cfg.vocab_size, (1, n)))
               for n in (27, 21, 15)]
    got = {}

    def pump():
        for lane, wav in b.pump(max_iters=4).items():
            got.setdefault(lane, []).append(wav)

    lanes = []
    for i, (emb, toks) in enumerate(streams):
        lanes.append(b.admit(np.zeros((1, 0), np.int32),
                             np.zeros((1, 0, b.n_mel), np.float32), emb))
        b.push(lanes[-1], toks)
        if i:
            b.finish(lanes[i - 1])
        pump()
    b.finish(lanes[-1])
    while b.free_lanes < 3:
        pump()
    assert b._steps.replays[("voc",)] > 0
    steady = sum(k == "steady" for h in hops.values() for k, _ in h)
    assert steady > b._steps.replays[("voc",)] + b._steps.captures[("voc",)]
    for lane in lanes:
        wavs, voc = [], None
        for kind, mel in hops[lane]:
            with torch.inference_mode():
                wav, voc = vocode_hop(
                    dec.hift, b._fade_in, b._fade_out, b.mel_cache_len,
                    b.dt, mel, voc, kind == "first", kind == "fin",
                    b._voc_draws if kind == "steady" else None)
            wavs.append(wav)
        want = torch.cat(wavs, dim=1).cpu().numpy()
        have = np.concatenate(got[lane], axis=1)
        peak = float(np.abs(want).max())
        err = float(np.abs(have - want).max())
        assert have.shape == want.shape and peak > 0.01
        assert err <= BF16_LANES_TOL * peak, (lane, err, peak)


def test_telemetry_device_spans_resolve_lazily(card):
    """A span with ``device`` times its work between CUDA events, resolved
    without a synchronize once the work has passed (or on a wait), and
    records no event inside a graph capture."""
    from moss_speech_decoder_cosy_torch.utils.profiling import LatencyStats
    st = LatencyStats()
    torch.cuda.synchronize()
    with st.span("slow", device=card):
        torch.cuda._sleep(50_000_000)
    st.resolve()
    assert st.spans("slow")[0].device_ms is None    # still running
    st.resolve(wait=True)
    assert st.spans("slow")[0].device_ms > 1.0
    x = torch.zeros(8, device=card)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph, stream=stream):
        with st.span("captured", device=card):
            x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    st.resolve(wait=True)
    assert st.spans("captured")[0].device_ms is None
    assert float(x[0]) == 2.0


class _TeeEngine:
    """An ``AudioBatchEngine`` whose streams also keep the float chunks they
    hand to ``decode_stream`` (request i's in ``chunks[i]``)."""

    def __init__(self, engine):
        self.engine, self.decoder, self.chunks = engine, engine.decoder, []

    async def open(self, **kw):
        rec = []
        self.chunks.append(rec)
        stream = await self.engine.open(**kw)

        class Tee:
            push, finish, rid = stream.push, stream.finish, stream.rid

            async def __aiter__(self):
                async for c in stream:
                    rec.append(c)
                    yield c
        return Tee()


def test_decode_stream_core_two_clients_on_card(card):
    """Two concurrent ``decode_stream`` requests (pcm16) through one
    ``AudioBatchEngine`` on the card after its boot warm-up: each body is
    the clip-and-scale of the engine's float chunks for that request,
    sample for sample, and the warm-up's graphs are the ones replayed."""
    import asyncio
    from moss_speech_decoder_cosy_torch.serving.audio_batcher import (
        AudioBatchEngine, decode_stream)
    from moss_speech_decoder_cosy_torch.serving.boot import (
        boot_warmup_batcher)
    dec = _tiny_batcher_decoder(card)
    cfg = dec.flow_cfg
    rng = np.random.RandomState(14)
    reqs = [{"tokens": rng.randint(0, cfg.vocab_size, (1, n)).tolist(),
             "embedding": rng.randn(1, cfg.spk_embed_dim).tolist()}
            for n in (21, 13)]

    async def body(engine, req):
        status, headers, chunks = await decode_stream(engine, req)
        assert status == 200 and headers["Content-Type"] == "audio/L16"
        return np.frombuffer(b"".join([c async for c in chunks]), "<i2")

    async def run():
        engine = AudioBatchEngine(dec, n_lanes=2, ring_tokens=6,
                                  token_cap=64)
        boot_warmup_batcher(engine.batcher, pump_iters=engine.pump_iters,
                            verbose=False)
        before = _graph_ids(engine.batcher)
        tee = _TeeEngine(engine)
        bodies = await asyncio.gather(*[body(tee, r) for r in reqs])
        return bodies, tee.chunks, before == _graph_ids(engine.batcher)

    bodies, chunks, same_graphs = asyncio.run(run())
    assert same_graphs
    for got, rec, r in zip(bodies, chunks, reqs):
        want = (np.clip(np.concatenate(rec, axis=1)[0], -1, 1)
                * 32767.0).astype("<i2")
        assert len(got) == (len(r["tokens"][0]) * cfg.token_mel_ratio
                            * dec.hift_cfg.total_upsample)
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- speech LM
def _card_lm(card, dtype=torch.bfloat16, layers=2):
    """The CosyVoice2 LM at full width and ``layers`` layers, weights drawn
    from seed 12."""
    from moss_speech_decoder_cosy_torch.models.llm import speech_lm as TS
    from moss_speech_decoder_cosy_torch.models.llm.qwen2 import Qwen2Config
    from moss_speech_decoder_cosy_torch.weights import seeded_state
    cfg = TS.SpeechLMConfig(backbone=dataclasses.replace(
        Qwen2Config(), num_layers=layers, max_seq_len=512))
    with torch.device("meta"):
        lm = TS.Qwen2SpeechLM(cfg)
    return TS.load_lm(TS.Qwen2SpeechLM, cfg, seeded_state(lm, 12),
                      dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lm_graphed_generate_equals_eager_and_captures_once(card, dtype):
    """``generate`` replayed as CUDA graphs gives the eager tokens for the
    same seed; its one graph is captured at the first call and replayed by
    every later call (the same graph object, no second capture), whatever
    its ``max_len``: a shorter cap replays it and gives the first tokens."""
    lm = _card_lm(card, dtype)
    emb = lm.prompt_embeds(np.arange(3, 40)[None], np.zeros((1, 0)))
    runner = lm.graphs()
    state = lm._generator()[0]
    captures = []
    capture = runner._capture
    runner._capture = lambda fn: captures.append(1) or capture(fn)
    first, n = lm.generate(emb, 5, 60, 60)
    graph = runner.graphs[("gen", 16)][0]
    for seed in (5, 6, 5):
        got, m = lm.generate(emb, seed, 60, 60)
        want, k = lm.generate(emb, seed, 60, 60, graphs=False)
        assert m == k == 60
        assert torch.equal(got, want)
    assert torch.equal(got, first) and n == 60
    short, m = lm.generate(emb, 5, 40, 40)
    assert m == 40 and torch.equal(short, first[:40])
    assert len(captures) == 1 and runner.graphs[("gen", 16)][0] is graph
    assert sorted(runner.graphs) == [("gen", 16)]
    assert lm.graphs() is runner and lm._generator()[0] is state


@pytest.mark.parametrize("recent,dtype", [(0, torch.bfloat16),
                                          (40, torch.float32)],
                         ids=["bf16", "two_tier_f32"])
def test_lm_batcher_tokens_do_not_depend_on_slot_or_neighbours(
        card, recent, dtype):
    """At full width: a request's tokens through the graphed batcher equal
    ``generate``'s for its seed, whichever slot it lands in and whoever
    decodes beside it.  The two-tier cache scores [main ++ recent], split
    where the batcher's flushes fall, so it runs the same attention only up
    to rounding: it is held in f32 (in bf16 a rounding can flip a pick)."""
    from moss_speech_decoder_cosy_torch.serving.lm_server import (
        ContinuousBatcher)
    lm = _card_lm(card, dtype)
    rng = np.random.RandomState(15)
    reqs = [(rng.randint(0, 151936, n), s) for n, s in
            ((20, 1), (31, 2), (12, 3), (25, 4), (17, 5))]
    want = []
    for text, seed in reqs:
        toks, n = lm(text[None], np.zeros((1, 0)), seed=seed, max_len=48)
        want.append(toks[:n].tolist())
    for order in ([0, 1, 2, 3, 4], [4, 2, 0, 3, 1]):
        b = ContinuousBatcher(lm, slots=3, step_chunk=8, recent=recent)
        pending, ids = list(order), {}
        for _ in range(100):
            if pending:
                text, seed = reqs[pending[0]]
                q = b.submit(text, seed=seed, max_len=48)
                if q is not None:
                    ids[pending.pop(0)] = q
            b.step()
            if not pending and all(b.finished(q) for q in ids.values()):
                break
        for i, q in ids.items():
            assert b.result(q) == want[i], (order, i)


def test_v1_token2wav_on_card_matches_cpu(card):
    """The CosyVoice-v1 decoder at full width (``cosyvoice1_flow_config()``
    with flash, ``cosyvoice1_hift_config()``), f32, seeded weights, behind
    a prompt: exactly 64 flash launches an Euler step (640 a flow call),
    the mel within 1e-4 of the CPU path's, the wav 256 samples a frame."""
    from moss_speech_decoder_cosy_torch.model_dir import V1Decoder
    from moss_speech_decoder_cosy_torch.utils import config as C
    from moss_speech_decoder_cosy_torch.weights import seeded_states

    flow_cfg = C.cosyvoice1_flow_config()
    flow_cfg = dataclasses.replace(flow_cfg, estimator=dataclasses.replace(
        flow_cfg.estimator, use_flash_attention=True))
    hift_cfg = C.cosyvoice1_hift_config()
    states = seeded_states(flow_cfg, hift_cfg, seed=20, v1=True)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, flow_cfg.vocab_size, (1, 40))
    prompt = (rng.randint(0, flow_cfg.vocab_size, (1, 10)),
              rng.randn(1, 17, 80).astype(np.float32),
              rng.randn(1, 192).astype(np.float32))
    mels = {}
    for dev in ("cuda", "cpu"):
        dec = V1Decoder(flow_cfg, hift_cfg, *states, device=dev)
        mels[dev] = dec.flow_mel(tokens, *prompt).cpu()
    dec_card = V1Decoder(flow_cfg, hift_cfg, *states, device="cuda")
    fa.launch_flash_chunk_attention.launches = 0
    wav = dec_card.token2wav(tokens, *prompt)
    torch.cuda.synchronize()
    assert fa.launch_flash_chunk_attention.launches == 640
    n = dec_card.mel_len(40)
    assert mels["cuda"].shape == (1, n, 80)
    assert wav.shape == (1, 256 * n) and np.isfinite(wav).all()
    err = float((mels["cuda"] - mels["cpu"]).abs().max())
    assert err <= 1e-4, err


# the 24 kHz source card against CPU: chip_smoke.py's HIFT_SOURCE_TOL
HIFT_SOURCE_TOL = 1e-2


@pytest.mark.parametrize("seconds", [20, 30])
def test_24k_source_on_card_matches_cpu(card, seconds):
    """The MOSS vocoder's NSF source (``SourceModuleHnNSF2``) over a seeded
    voiced f0 contour, f32, card against CPU with the same draws: its
    frame-rate phase scan runs along a contiguous axis (4.4e-3 off over
    30 s on an H100; a strided scan put it 0.018 off)."""
    from moss_speech_decoder_cosy_torch.models.hift.generator import (
        SourceModuleHnNSF2, seeded_draws)
    from moss_speech_decoder_cosy_torch.utils.config import moss_hift_config
    from moss_speech_decoder_cosy_torch.weights import seeded_state

    cfg = moss_hift_config()
    frames = seconds * cfg.sampling_rate // cfg.total_upsample
    rng = np.random.RandomState(31 + seconds)
    t = np.arange(frames) / 50.0
    f0 = 140 + 50 * np.sin(2 * np.pi * 0.3 * t) + rng.randn(frames) * 3
    f0[rng.rand(frames) < 0.1] = 0.0
    f0 = np.repeat(f0, cfg.total_upsample)[None, :, None].astype(np.float32)
    with torch.device("meta"):
        state = seeded_state(SourceModuleHnNSF2(cfg), 30)
    draws = seeded_draws(cfg.nb_harmonics + 1, f0.shape[1], "cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        m = SourceModuleHnNSF2(cfg)
        m.load_state_dict(state)
        m = m.to(dev)
        with torch.inference_mode():
            got[dev] = m(torch.from_numpy(f0).to(dev),
                         *(d.to(dev) for d in draws)).cpu()
    assert torch.isfinite(got["cuda"]).all()
    err = float((got["cuda"] - got["cpu"]).abs().max())
    assert err <= HIFT_SOURCE_TOL, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_asr_graphed_decodes_equal_eager(card, dtype):
    """The tiny ASR's decodes on the card: greedy (through the fallback
    ladder), beam 4 and timestamp tokens with each step a replayed CUDA
    graph equal the same steps run eagerly; every step after the first
    call of a shape replays, and a second call of other states reuses the
    graphs."""
    from moss_speech_decoder_cosy_torch.tokenizer import tiny_tokenizer_config
    from moss_speech_decoder_cosy_torch.tokenizer.asr_decoder import (
        DecodeSteps, PostVQEncoder, WhisperASR, WhisperVQDecoder)
    from moss_speech_decoder_cosy_torch.weights import seeded_state

    cfg = tiny_tokenizer_config()
    with torch.device("meta"):
        post, dec = PostVQEncoder(cfg), WhisperVQDecoder(cfg)
    codebook = np.random.RandomState(1).randn(
        cfg.quantize_vocab_size, cfg.d_model).astype(np.float32)
    kw = dict(max_len=16, segment_tokens=8, timestamp_begin=cfg.vocab_size - 16,
              dtype=dtype)
    asr = WhisperASR(cfg, seeded_state(post, 2), seeded_state(dec, 3),
                     codebook, **kw)
    ids = np.random.RandomState(2).randint(0, cfg.quantize_vocab_size, (1, 20))
    enc, valid = asr.encode_segments(ids)
    eager = DecodeSteps(asr.dec, 16, graphs=False)
    for s in range(enc.shape[0]):
        e, v = enc[s:s + 1], valid[s:s + 1]
        calls = (lambda x: x.sample(e, v, 1, 2)[:2],
                 lambda x: x.sample(e, v, 1, 2, temperature=0.7, seed=s),
                 lambda x: x.beam(e, v, 1, 2, 4)[:2],
                 lambda x: x.timestamp(e, v, 1, 2, asr.timestamp_begin))
        for call in calls:
            for a, b in zip(call(asr.steps), call(eager)):
                assert torch.equal(a, b)
    steps = asr.steps.steps
    assert len(steps.graphs) == 3 and not eager.steps.graphs
    # 3 segments x 4 decodes x 15 steps, the 3 first calls capturing
    assert sum(steps.replays.values()) == 3 * 4 * 15 - 3
    assert sum(steps.captures.values()) == 3
    got = asr.transcribe(ids, temperatures=(0.0, 0.7))
    assert len(got) == 3 and all(g.dtype == np.int32 for g in got)


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("entry", ["flash_chunk_attention",
                                   "flash_chunk_attention_fl",
                                   "fused_tf_group", "fused_conformer_group"])
def test_kernel_entries_raise_under_autograd_on_card(card, entry):
    """A CUDA tensor that requires grad never reaches a kernel: the entry
    raises naming its switch and launches nothing."""
    from moss_speech_decoder_cosy_torch.ops import fused_block as fb
    from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
    if entry.startswith("flash"):
        q, k, v = _qkv((1, 2, 8, 64), torch.float32, 3)
        if entry.endswith("_fl"):
            q, k, v = (x.transpose(1, 2).reshape(1, 8, 128)
                       for x in (q, k, v))
            counter, switch = fa.launch_flash_chunk_attention, \
                "use_flash_attention"

            def call():
                fa.flash_chunk_attention_fl(q.requires_grad_(True), k, v,
                                            heads=2)
        else:
            counter, switch = fa.launch_flash_chunk_attention, \
                "use_flash_attention"

            def call():
                fa.flash_chunk_attention(q.requires_grad_(True), k, v)
    elif entry == "fused_tf_group":
        p, rp_, mt, cc1, cc2, x, rings = fb.make_group_inputs(
            6, 6, 16, 8, 2, 4, 2, 24, torch.float32, card, seed=5)
        scal = fb.group_scalars([6] * 6, [0] * 6, [1] * 6, card)
        counter, switch = fb.launch_fused_tf_group, "kernel"

        def call():
            fb.fused_tf_group(p, rp_, mt, cc1, cc2, x.requires_grad_(True),
                              rings, scal, 0, heads=2, head_dim=4)
    else:
        p, x, pe, kv, pk = fc.make_conformer_inputs(
            2, 3, 16, 2, 32, 6, torch.float32, card, seed=3)
        counter, switch = fc.launch_fused_conformer_group, "enc_kernel"

        def call():
            fc.fused_conformer_group(p, x.requires_grad_(True), pe, kv, pk,
                                     0, heads=2, head_dim=8)
    before = counter.launches
    with pytest.raises(RuntimeError, match=switch):
        call()
    assert counter.launches == before


def test_flow_train_step_on_card_matches_cpu(card):
    """One ``make_flow_train_step`` step at the tiny flow config with the
    same draws on both devices (drawn on the host): the loss within 1e-5
    relative, every gradient within 1e-4 of its peak (plus 1e-7 of the
    largest, for gradients zero in exact arithmetic), the card's step
    launching no kernel."""
    from moss_speech_decoder_cosy_torch.models.flow.cfm import CFMDraws
    from moss_speech_decoder_cosy_torch.models.flow.flow import (
        FlowLossDraws)
    from moss_speech_decoder_cosy_torch.training import (
        create_flow_train_state, make_flow_train_step)
    from moss_speech_decoder_cosy_torch.utils.config import tiny_flow_config
    cfg = tiny_flow_config()
    rng = np.random.RandomState(0)
    b, tt = 2, 12
    tm = tt * cfg.token_mel_ratio
    arrays = dict(
        speech_token=rng.randint(0, cfg.vocab_size, (b, tt)),
        token_valid=np.ones((b, tt), bool),
        speech_feat=rng.randn(b, tm, cfg.output_size).astype(np.float32),
        feat_valid=np.ones((b, tm), bool),
        embedding=rng.randn(b, cfg.spk_embed_dim).astype(np.float32))
    d = FlowLossDraws.draw((b, tm, cfg.output_size),
                           torch.Generator().manual_seed(1), "cpu")
    got = {}
    for dev in (card, torch.device("cpu")):
        state = create_flow_train_state(cfg, seed=2, device=dev)
        step = make_flow_train_step(state.model)
        draws = FlowLossDraws(d.prompt.to(dev), d.keep.to(dev), CFMDraws(
            d.cfm.t.to(dev), d.cfm.z.to(dev), d.cfm.cfg.to(dev)))
        before = fa.launch_flash_chunk_attention.launches
        state, m = step(state, {k: torch.as_tensor(v).to(dev)
                                for k, v in arrays.items()},
                        draws=lambda i, mb: (draws, None))
        assert fa.launch_flash_chunk_attention.launches == before
        got[dev.type] = (float(m["loss"]), {
            k: p.grad.cpu().numpy() for k, p in state.model.named_parameters()})
    (lc, gc), (lh, gh) = got["cuda"], got["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    top = max(float(np.abs(g).max()) for g in gh.values())
    for k, g in gh.items():
        assert float(np.abs(gc[k] - g).max()) <= \
            1e-4 * float(np.abs(g).max()) + 1e-7 * top, k


def test_aot_compile_replays_equal_eager(card):
    """``utils.export.aot_compile`` of the tiny Qwen2 backbone's causal
    forward: one CUDA graph, each call a replay equal to the eager call."""
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, tiny_speech_lm_config)
    from moss_speech_decoder_cosy_torch.utils.export import aot_compile
    from moss_speech_decoder_cosy_torch.weights import seeded_module
    lm = seeded_module(lambda: Qwen2SpeechLM(tiny_speech_lm_config()), 0,
                       card).eval()
    g = torch.Generator(card).manual_seed(0)
    xs = [torch.randn(2, 9, 32, device=card, generator=g) for _ in range(3)]
    call = aot_compile(lm.llm.forward_causal, xs[0])
    with torch.inference_mode():
        for x in xs[1:]:
            want = lm.llm.forward_causal(x)
            assert float((call(x) - want).abs().max()) <= \
                1e-6 * float(want.abs().max())
    assert list(call.graphs.graphs) == [("aot",)]
    assert call.graphs.replays == {("aot",): 2}
    with pytest.raises(ValueError, match="compiled for"):
        call(torch.zeros(1, 9, 32, device=card))


@pytest.fixture
def nccl_world_one(card):
    """A process group of one rank on the card (NCCL), torn down after."""
    import socket
    from moss_speech_decoder_cosy_torch.parallel import distributed as D
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    D.initialize(f"127.0.0.1:{port}", 1, 0, device=card)
    yield card
    D.shutdown()


def test_nccl_group_data_and_tensor_parallel_steps(nccl_world_one):
    """World size 1 over NCCL: the group's sum on the card; the
    data-parallel flow step with ZeRO moments equal to the single-process
    step with the same draws (loss 1e-6 relative, parameters 1e-6); the
    tensor-parallel tiny LM's loss equal to the unsharded one (2e-5)."""
    import copy
    import torch.distributed as dist
    from moss_speech_decoder_cosy_torch.models.flow.flow import (
        FlowLossDraws)
    from moss_speech_decoder_cosy_torch.models.llm.speech_lm import (
        Qwen2SpeechLM, tiny_speech_lm_config)
    from moss_speech_decoder_cosy_torch.parallel.mesh import data_group
    from moss_speech_decoder_cosy_torch.parallel.tp import tensor_parallel
    from moss_speech_decoder_cosy_torch.training import (
        create_flow_train_state, lm as LM, make_flow_train_step,
        make_optimizer)
    from moss_speech_decoder_cosy_torch.utils.config import tiny_flow_config
    from moss_speech_decoder_cosy_torch.weights import seeded_module
    card = nccl_world_one
    assert dist.get_backend() == "nccl"
    dg = data_group()
    assert float(dg.sum(torch.ones(3, device=card)).sum()) == 3.0
    cfg = tiny_flow_config()
    rng = np.random.RandomState(0)
    b, tt = 2, 12
    tm = tt * cfg.token_mel_ratio
    batch = {k: torch.as_tensor(v).to(card) for k, v in dict(
        speech_token=rng.randint(0, cfg.vocab_size, (b, tt)),
        token_valid=np.ones((b, tt), bool),
        speech_feat=rng.randn(b, tm, cfg.output_size).astype(np.float32),
        feat_valid=np.ones((b, tm), bool),
        embedding=rng.randn(b, cfg.spk_embed_dim).astype(
            np.float32)).items()}
    d = FlowLossDraws.draw((b, tm, cfg.output_size),
                           torch.Generator(card).manual_seed(1), card)
    got = {}
    for dp in (None, dg):
        state = create_flow_train_state(
            cfg, seed=2, device=card,
            optimizer=make_optimizer(zero=dp))
        state, m = make_flow_train_step(state.model, dp=dp)(
            state, batch, draws=lambda i, mb: (d, None))
        got[dp is None] = (float(m["loss"]), {
            k: p.detach().clone() for k, p in state.model.named_parameters()})
    (l1, p1), (l2, p2) = got[True], got[False]
    assert abs(l2 - l1) <= 1e-6 * abs(l1)
    for k in p1:
        assert float((p2[k] - p1[k]).abs().max()) <= 1e-6, k
    lm_cfg = tiny_speech_lm_config()
    ref = seeded_module(lambda: Qwen2SpeechLM(lm_cfg), 0, card).eval()
    tp = tensor_parallel(copy.deepcopy(ref))
    lm_batch = {
        "text_token": torch.tensor([[3, 5, 7, 9]], device=card),
        "text_token_len": torch.tensor([4], device=card),
        "speech_token": torch.tensor([[1, 2, 3]], device=card),
        "speech_token_len": torch.tensor([3], device=card)}
    with torch.no_grad():
        want = float(LM.lm_loss(ref, lm_batch)[0])
        assert abs(float(LM.lm_loss(tp, lm_batch)[0]) - want) <= \
            2e-5 * abs(want)
