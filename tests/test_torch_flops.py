"""FLOP accounting of the port (``utils/flops.py``) on the CPU, tiny
configs, against the JAX package's (``utils/flops.py``, XLA cost analysis)
and its properties (tests/test_pipeline.py, tests/test_kv_batcher.py):

- ``count_flops`` counts a known matmul as exactly 2·m·n·k;
- the hand-written kernels' entries count the JAX package's analytic
  formulas and keep their plain versions' products out of the tally;
- ``program_flops`` of the KV session and of the windowed device session:
  positive, growing with the stream's length, the KV session below the
  windowed one; the kernel engine's count above the unfused engine's by
  exactly the formula's block-diagonal attention term;
- the port's count against the JAX package's XLA count of the same session.
  XLA's cost analysis counts a loop's body once, whatever its trip count
  (a scan of 8 hops counts as one hop).  So the JAX KV session's
  wavefront scan is unrolled for the count (its ``_unroll`` set to the
  scan's length; it then counts its bucket's dead iterations as well, and
  element-wise work): the port's count is within 2x of it.  The windowed
  session's flow forwards each hold the ODE's scan of S steps, counted
  once: the port's count lies between the JAX count and S times it;
- peaks and MFU are None on the CPU."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from moss_speech_decoder_cosy_tpu.models.flow import CausalMaskedDiffWithXvec
from moss_speech_decoder_cosy_tpu.models.hift import HiFTGenerator
from moss_speech_decoder_cosy_tpu.pipeline import AudioDecoder as JDecoder
from moss_speech_decoder_cosy_tpu.utils.config import (
    CFMConfig, PipelineConfig, tiny_flow_config, tiny_hift_config)
from moss_speech_decoder_cosy_torch.ops import fused_block as fb
from moss_speech_decoder_cosy_torch.ops import fused_conformer as fc
from moss_speech_decoder_cosy_torch.pipeline import AudioDecoder as TDecoder
from moss_speech_decoder_cosy_torch.utils import config as tcfg
from moss_speech_decoder_cosy_torch.utils import flops
from moss_speech_decoder_cosy_torch.weights import (
    flow_state_from_jax, hift_state_from_jax)

BLOCK, N1, N2 = 2, 21, 41


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def decoders():
    """The JAX package's flops test's configuration (3 ODE steps, hop 2, mel
    cache 2, window 8) in both packages, same weights."""
    cfg = dataclasses.replace(tiny_flow_config(),
                              cfm=CFMConfig(n_timesteps=3,
                                            max_noise_len=2048))
    hcfg = tiny_hift_config()
    fp = jax.jit(CausalMaskedDiffWithXvec(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool), jnp.zeros((1, 0, cfg.output_size)),
        jnp.zeros((1, cfg.spk_embed_dim)))
    hp = jax.jit(HiFTGenerator(hcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, cfg.output_size)))
    jdec = JDecoder(cfg, hcfg, fp, hp, PipelineConfig(
        block_size=BLOCK, mel_cache_len=2, max_token_len=8))
    tcfg_flow = dataclasses.replace(
        tcfg.tiny_flow_config(),
        cfm=tcfg.CFMConfig(n_timesteps=3, max_noise_len=2048))
    tdec = TDecoder(tcfg_flow, tcfg.tiny_hift_config(),
                    flow_state_from_jax(jax.tree.map(np.asarray, fp)),
                    hift_state_from_jax(jax.tree.map(np.asarray, hp)),
                    tcfg.PipelineConfig(block_size=BLOCK, mel_cache_len=2,
                                        max_token_len=8), device="cpu")
    return jdec, tdec


@pytest.fixture(scope="module")
def counts(decoders):
    """program_flops of the port's sessions at N1 and N2 tokens."""
    _, tdec = decoders
    kv = {k: tdec.kv_stream_decoder(block_size=BLOCK, token_cap=64,
                                    kernel=k) for k in (True, False)}
    win = tdec.device_stream_decoder()
    out = {}
    for n in (N1, N2):
        for k, sess in kv.items():
            out["kv", k, n] = sess.program_flops(n)
        out["win", n] = win.program_flops(n)
    out["sessions"] = (kv, win)
    return out


def test_a_known_matmul_counts_2mnk():
    a, b = torch.zeros(32, 16), torch.zeros(16, 8)
    out, n = flops.count_flops(lambda: a @ b)
    assert out.shape == (32, 8) and n == 2 * 32 * 16 * 8


def test_fused_tf_group_counts_its_formula_not_its_plain_body():
    """Inside a tally, the CPU entry runs the plain version and counts the
    JAX package's cost estimate of the launch instead of its products."""
    rows, cf, cin, ch, heads, hd, rp, L = 6, 8, 20, 12, 2, 4, 24, 2
    args = fb.make_group_inputs(rows, cf, cin, ch, heads, hd, L, rp,
                                torch.float32, "cpu") + (
        fb.group_scalars([cf] * rows, [0] * rows, [1] * rows, "cpu"), 0)
    want = (2 * rows * cf * (3 * cin * ch + 3 * ch * ch + cin * ch)
            + 2 * rows * 4 * ch * ch
            + L * 2 * rows * cf * (3 * ch * heads * hd + heads * hd * ch
                                   + 8 * ch * ch)
            + L * 8 * rows * rp * cf * heads * hd)
    _, got = flops.count_flops(lambda: fb.fused_tf_group(
        *args, heads=heads, head_dim=hd))
    assert got == want == flops.fused_tf_group_flops(
        rows, cf, cin, ch, heads * hd, L, rp)
    _, plain = flops.count_flops(lambda: fb.fused_tf_group_plain(
        *args, heads=heads, head_dim=hd))
    assert plain > 0 and plain != got


def test_fused_conformer_group_counts_its_formula():
    L, c, d, rt, heads = 2, 5, 16, 12, 2
    args = fc.make_conformer_inputs(L, c, d, heads, 4 * d, rt,
                                    torch.float32, "cpu") + (7,)
    _, got = flops.count_flops(lambda: fc.fused_conformer_group(
        *args, heads=heads, head_dim=d // heads))
    assert got == L * (2 * c * d * 13 * d + 6 * c * (rt + c) * d
                       + 6 * rt * c * d)


def test_program_flops_positive_growing_kv_below_windowed(counts):
    for n in (N1, N2):
        assert 0 < counts["kv", True, n] and 0 < counts["kv", False, n]
        assert counts["kv", True, n] < counts["win", n]
    for key in (("kv", True), ("kv", False), ("win",)):
        assert counts[key + (N2,)] > counts[key + (N1,)]


def test_kernel_engine_counts_the_unfused_engine_plus_block_diagonal(counts):
    """The unfused engine runs the same products as the formula but the
    attention once: the kernel engine's count exceeds it by
    L·4·rows·rp·cf·inner a launch, (2 + mid blocks) launches a wavefront
    iteration."""
    kv = counts["sessions"][0][True]
    e = kv.dec.flow_cfg.estimator
    rows, rp = kv.s_steps * 2, kv._ext["kv"][0].shape[1]
    inner = e.num_heads * e.attention_head_dim
    per_iter = ((2 + e.num_mid_blocks) * e.n_blocks * 4 * rows * rp * kv.cf
                * inner)
    for n in (N1, N2):
        k = sum(1 for _, fin in kv.schedule(n) if not fin)
        iters = k + kv.s_steps - 1
        assert counts["kv", True, n] - counts["kv", False, n] == \
            iters * per_iter


def jax_counts(jdec):
    """The JAX package's program_flops of its KV session (the wavefront scan
    unrolled, so that XLA counts every iteration) and of its windowed
    session, at N1 tokens."""
    toks = np.random.RandomState(0).randint(0, 64, (1, N1)).astype(np.int32)
    jwin = jdec.device_stream_decoder()
    jwin.stream_decode(toks)
    jkv = jdec.kv_stream_decoder(block_size=BLOCK, token_cap=64)
    jkv.stream_decode(toks)
    k = sum(1 for _, fin in jkv.schedule(N1) if not fin)
    jkv._unroll = max(16, -(-(k + 2) // 16) * 16)    # the scan's length
    return jkv.program_flops(N1), jwin.program_flops(N1)


def test_program_flops_against_the_jax_count(decoders, counts):
    """The port's unfused engine is the JAX CPU session's XLA engine's
    twin."""
    jax_kv, jax_win = jax_counts(decoders[0])
    got = counts["kv", False, N1]
    assert jax_kv / 2 <= got <= 2 * jax_kv, (got, jax_kv)
    s_steps = decoders[1].flow_cfg.cfm.n_timesteps
    assert jax_win <= counts["win", N1] <= s_steps * jax_win


def test_meter_counts_nothing_while_off(counts):
    kv = counts["sessions"][0][False]
    kv.meter.reset()
    kv.stream_decode(np.zeros((1, N1), np.int32))
    assert kv.meter.dispatches() == 0 and kv.meter.total_flops() == 0


def test_peaks_and_mfu_are_none_on_the_cpu():
    assert flops.chip_peak_flops("cpu") is None
    assert flops.chip_peak_flops("cpu", torch.float32) is None
    assert flops.mfu(1e12, 1.0, "cpu") is None
    assert flops.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


if __name__ == "__main__":
    # the ratios that PERF.md reports:
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_flops.py
    torch.set_num_threads(1)
    jdec, tdec = decoders.__wrapped__()
    got = counts.__wrapped__((jdec, tdec))
    jax_kv, jax_win = jax_counts(jdec)
    for name, port, ref in (("KV (unfused engine)", got["kv", False, N1],
                             jax_kv),
                            ("KV (kernel engine)", got["kv", True, N1],
                             jax_kv),
                            ("windowed", got["win", N1], jax_win)):
        print(f"{name}, {N1} tokens: port {port:.6g} FLOPs, JAX XLA "
              f"{ref:.6g}, port / JAX {port / ref:.3f}")
