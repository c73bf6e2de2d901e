"""KV-cached streaming decode, after the JAX package's
``pipeline/kv_session.py``.

The windowed session (``audio_decoder.StreamSession``) re-decodes a bounded
token window per hop, as the reference does.  This session pushes every
token through the flow once, attending to circular KV rings
(``models/flow/kv_stream.py``).  ``stream_decode`` runs:

- a prompt prefill through the per-hop KV step (when there is a prompt);
- the steady hops as a wavefront: the encoder per hop, then one estimator
  forward per iteration that batches all S ODE steps (slot s holds the
  chunk that has done s Euler steps).  The loop runs exactly the
  k + S - 1 live iterations; the JAX package's scan padded them to buckets
  of 16 for XLA;
- the finalize tail through the per-hop KV step;
- bulk vocoding of the whole hop chain (``bulk_voc.py``), or the per-hop
  vocoder chain.

The estimator rings live in HBM at 56 layers x (S*2B, ring + chunk,
2*inner): 367 MB per stream in bf16 at the MOSS geometry.  They are updated
IN PLACE (the kernel writes each chunk into its ring), which takes the
place of the JAX package's buffer donation.

Engines of the wavefront: ``kernel=True`` runs each resnet + transformer
group of the estimator as one ``fused_tf_group`` launch
(``ops/fused_block.py``); ``kernel=False`` runs the unfused per-layer
engine.  ``kernel="auto"`` picks the kernel engine whenever the geometry
allows it (``fused_block.kernel_limit``: in bf16 a hop of at most 32
frames), on every device: on the CPU its wrapper runs the plain version.
``enc_kernel=True`` (opt-in, as in the JAX package) runs the wavefront's
per-hop encoder with each conformer stack as one ``fused_conformer_group``
launch (``ops/fused_conformer.py``); the prefill and the finalize hop keep
the per-layer encoder step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.flow.kv_stream import (
    encoder_hop_kernel, est_cache_from_flat, est_cache_to_flat,
    extend_rings_for_fused, fuse_qkv_params, group_encoder_params,
    group_est_flat, group_estimator_params, init_kv_cache,
    kv_flow_encode_step, kv_flow_step, pe_tables, shrink_rings_from_fused,
    noise_chunk, spk_embedding, ungroup_est_flat, wave_step,
    wave_step_kernel)
from ..ops.fused_block import kernel_limit
from .bulk_voc import BulkVocoder


@dataclasses.dataclass
class KVVocState:
    """Per-hop vocoder caches on the device."""
    mel_cache: torch.Tensor        # (1, mel_cache_len, n_mel) f32
    source_cache: torch.Tensor     # (1, scl, 1) f32
    speech_cache: torch.Tensor     # (1, scl) f32


class KVStreamDecoder:
    """Incremental streaming decoder bound to an ``AudioDecoder``'s modules,
    one stream.  Geometry: ``block_size`` tokens per hop, a ring of
    ``ring_tokens`` tokens of left context; ``fused`` selects the
    write-then-attend wavefront (needs ``ring_tokens % block_size == 0``,
    the shared-offset write geometry)."""

    def __init__(self, dec, prompt_token: np.ndarray,
                 prompt_feat: np.ndarray, embedding: np.ndarray,
                 block_size: int, ring_tokens: int = 35,
                 token_cap: int = 2048, fused: bool = True, kernel="auto",
                 enc_kernel: bool = False):
        self.dec = dec
        self.hop = block_size
        self.ring_tokens = ring_tokens
        self.la = dec.lookahead
        self.ratio = dec.ratio
        self.p = int(prompt_token.shape[1])
        cfg = dec.flow_cfg
        self.n_mel = cfg.output_size
        self.mel_cache_len = dec.pipe_cfg.mel_cache_len
        self.scl = dec.source_cache_len
        self.dev = dec.device
        self.dt = dec._dt()
        self.est_dt = dec.estimator_dtype or self.dt
        self.s_steps = cfg.cfm.n_timesteps
        self.cf = block_size * self.ratio
        self._fused = bool(fused)
        self._dus_ok = ring_tokens % block_size == 0
        if self._fused and not self._dus_ok:
            raise NotImplementedError(
                f"ring_tokens {ring_tokens} is not a multiple of the hop "
                f"{block_size}: the one-hot fused write (write_mode="
                f"'onehot') is not ported")
        # prompt alignment of the shared write offset (frames % hop)
        self._align = (self.p * self.ratio) % self.cf
        est_cfg = cfg.estimator
        why = kernel_limit(self.cf, est_cfg.attention_head_dim, self.est_dt)
        kernel_ok = self._fused and est_cfg.act_fn == "gelu" and not why
        if kernel == "auto":
            kernel = kernel_ok
        if kernel and not kernel_ok:
            raise ValueError("the kernel engine needs fused=True, the "
                             "shared-offset geometry and exact GELU"
                             + (f"; {why}" if why else ""))
        self._kernel = bool(kernel)

        self._prompt_tok = torch.as_tensor(np.asarray(prompt_token),
                                           dtype=torch.long).to(self.dev)
        self._prompt_feat = torch.as_tensor(
            np.asarray(prompt_feat, np.float32)).to(self.dev, self.dt)
        self._emb = torch.as_tensor(np.asarray(embedding, np.float32)).to(
            self.dev, self.dt)
        self._pe_tok, self._pe_mel = pe_tables(cfg, token_cap + self.p + 16,
                                               self.dev)
        win = torch.from_numpy(np.hamming(2 * self.scl).astype(np.float32))
        self._fade_in = win[: self.scl].to(self.dev)
        self._fade_out = win[self.scl:].to(self.dev)

        # q/k/v re-pack and the kernel's packed weights: once per decoder
        self._fw = getattr(dec, "_fused_qkv", None)
        if self._fw is None:
            self._fw = dec._fused_qkv = fuse_qkv_params(dec.flow)
        self._gp = None
        if self._kernel:
            self._gp = getattr(dec, "_grouped_est_params", None)
            if self._gp is None:
                self._gp = dec._grouped_est_params = group_estimator_params(
                    dec.flow, self._fw)
        self._enc_kernel = bool(enc_kernel)
        self._egp = None
        if self._enc_kernel:
            self._egp = getattr(dec, "_grouped_enc_params", None)
            if self._egp is None:
                self._egp = dec._grouped_enc_params = group_encoder_params(
                    dec.flow, self._fw)
        self._spks = None
        self._bulk: Optional[BulkVocoder] = None

    # ------------------------------------------------------------- state
    def init_state(self) -> Tuple[Dict, KVVocState]:
        cache = init_kv_cache(self.dec.flow_cfg, self.ring_tokens,
                              dtype=self.dt, est_dtype=self.est_dt,
                              device=self.dev)
        z = lambda *s: torch.zeros(s, device=self.dev)  # noqa: E731
        return cache, KVVocState(z(1, self.mel_cache_len, self.n_mel),
                                 z(1, self.scl, 1), z(1, self.scl))

    def _token_buf(self, tokens: np.ndarray) -> torch.Tensor:
        n = tokens.shape[1]
        buf = np.zeros((1, n + self.hop + self.la + 1), np.int64)
        buf[:, :n] = tokens
        return torch.from_numpy(buf).to(self.dev)

    def _slices(self, token_buf, n_tok: int, emit_tokens: int):
        off = n_tok - self.p
        return (token_buf[:, off:off + emit_tokens],
                token_buf[:, off + emit_tokens:off + emit_tokens + self.la])

    @torch.inference_mode()
    def _prefill(self, token_buf, cache):
        """The prompt as one chunk, with the first ``la`` stream tokens as
        lookahead; warms every ring, emits nothing."""
        _, cache = kv_flow_step(self.dec.flow, self._fw, self._prompt_tok,
                                token_buf[:, :self.la], self._prompt_feat,
                                self._emb, cache, self._pe_tok, self._pe_mel)
        return cache

    @torch.inference_mode()
    def _hop(self, token_buf, cache, emit_tokens: int, finalize: bool):
        """One flow hop through the per-hop KV step: the next chunk (and its
        lookahead) at the cache's own position.  Returns (mel f32, cache)."""
        chunk, ctx = self._slices(token_buf, cache["n_tok"], emit_tokens)
        cond = torch.zeros((1, emit_tokens * self.ratio, self.n_mel),
                           dtype=self.dt, device=self.dev)
        return kv_flow_step(self.dec.flow, self._fw, chunk, ctx, cond,
                            self._emb, cache, self._pe_tok, self._pe_mel,
                            finalize=finalize)

    @torch.inference_mode()
    def _voc(self, emit_mel, voc: KVVocState, first: bool, finalize: bool):
        """HiFT with the mel/source caches and the Hamming cross-fade.
        Returns (wav chunk (1, n) f32, new state)."""
        dt, scl = self.dt, self.scl
        if first:
            mel_in = emit_mel
            cache_source = None
        else:
            mel_in = torch.cat([voc.mel_cache.to(emit_mel.dtype), emit_mel],
                               dim=1)
            cache_source = voc.source_cache.to(dt)
        wav, source = self.dec.hift(mel_in.to(dt), cache_source)
        wav = wav.float()
        if not first:
            head = wav[:, :scl] * self._fade_in + voc.speech_cache * \
                self._fade_out
            wav = torch.cat([head, wav[:, scl:]], dim=1)
        if finalize:
            return wav, voc
        return wav[:, : wav.shape[1] - scl], KVVocState(
            mel_in[:, mel_in.shape[1] - self.mel_cache_len:].float(),
            source[:, source.shape[1] - scl:].float(),
            wav[:, wav.shape[1] - scl:])

    def schedule(self, n_tokens: int) -> List[Tuple[int, bool]]:
        """[(emit_tokens, finalize), ...]: steady hops while a full hop plus
        lookahead is available, then one finalize tail."""
        plan, off = [], 0
        while n_tokens - off >= self.hop + self.la:
            plan.append((self.hop, False))
            off += self.hop
        if n_tokens - off > 0:
            plan.append((n_tokens - off, True))
        return plan

    # -------------------------------------------------------------- flow
    def _flow_mels(self, token_buf, cache, plan):
        """The flow side of the plan hop by hop: (mel (1, T, n_mel), cache)."""
        mels = []
        for emit_tokens, finalize in plan:
            mel, cache = self._hop(token_buf, cache, emit_tokens, finalize)
            mels.append(mel)
        return torch.cat(mels, dim=1), cache

    def _encode_hop(self, token_buf, enc: Dict, n_tok: int):
        """The encoder of one steady hop at ``n_tok`` (the kernel hop when
        ``enc_kernel``): (mu chunk, new enc cache), rings written in place."""
        chunk, ctx = self._slices(token_buf, n_tok, self.hop)
        if self._enc_kernel:
            return encoder_hop_kernel(self._egp, self.dec.flow, chunk, ctx,
                                      enc, n_tok, self._pe_tok, self._pe_mel)
        return kv_flow_encode_step(self.dec.flow, self._fw, chunk, ctx, enc,
                                   n_tok, self._pe_tok, self._pe_mel)

    def _rot(self, rp: int) -> List[int]:
        """Per flat row, the slot rotation of the shared-offset scheme."""
        return [(s * self.cf) % rp for s in range(self.s_steps)
                for _ in range(2)]

    @torch.inference_mode()
    def _flow_mels_wave(self, token_buf, cache, plan):
        """The wavefront: the encoder per steady hop, one batched estimator
        forward per iteration, as one Python loop over the k + S - 1 live
        iterations (the kernel writes each chunk into the rings in place,
        where the JAX package donated the buffers).  Then the finalize tail
        through the per-hop step.  Returns (mel (1, T, n_mel) f32, cache)."""
        if not self._fused:
            raise NotImplementedError("the concat-dataflow wavefront is not "
                                      "ported: use fused=True")
        dec, cf, s_steps = self.dec, self.cf, self.s_steps
        flow = dec.flow
        k = sum(1 for _, fin in plan if not fin)
        base = self.p * self.ratio
        if self._spks is None:
            self._spks = spk_embedding(flow, self._emb)
        sd = (torch.float32 if dec.flow_cfg.cfm.solver_dtype == "float32"
              else self.dt)
        x_w = torch.zeros((s_steps, 1, cf, self.n_mel), dtype=sd,
                          device=self.dev)
        x_w[0] = noise_chunk(flow.decoder, base, cf, self.n_mel,
                             self.dev).to(sd)
        mu_w = torch.zeros((s_steps, 1, cf, self.n_mel), dtype=self.est_dt,
                           device=self.dev)

        rp = self.ring_tokens * self.ratio + cf
        rot = self._rot(rp)
        est = extend_rings_for_fused(est_cache_to_flat(cache["est"]), base,
                                     cf, rot)
        if self._kernel:
            est = group_est_flat(est, dec.flow_cfg.estimator)
        enc, n_tok = cache["enc"], self.p
        zeros = torch.zeros((1, cf, self.n_mel), dtype=self.dt,
                            device=self.dev)
        chunks = []
        for w in range(k + s_steps - 1):
            mu_new = zeros
            if w < k:
                mu_new, enc = self._encode_hop(token_buf, enc, n_tok)
                n_tok += self.hop
            if self._kernel:
                exit_mel, x_w, mu_w = wave_step_kernel(
                    self._gp, flow.decoder, x_w, mu_w, mu_new, self._spks,
                    est, w, k, base)
            else:
                exit_mel, x_w, mu_w = wave_step(
                    flow.decoder, self._fw, x_w, mu_w, mu_new, self._spks,
                    est, w, k, base)
            if w >= s_steps - 1:
                chunks.append(exit_mel)
        if self._kernel:
            est = ungroup_est_flat(est, dec.flow_cfg.estimator)
        est = shrink_rings_from_fused(est, base + k * cf, cf, rot)
        cache = {"enc": enc, "est": est_cache_from_flat(est, s_steps),
                 "n_tok": n_tok}
        mels = [torch.cat(chunks, dim=1)] if chunks else []
        if plan and plan[-1][1]:
            mel, cache = self._hop(token_buf, cache, plan[-1][0], True)
            mels.append(mel)
        return torch.cat(mels, dim=1), cache

    # ----------------------------------------------------------- decode
    @torch.inference_mode()
    def stream_decode(self, tokens: np.ndarray, bulk_voc: bool = True,
                      wavefront: bool = True) -> np.ndarray:
        """Whole-stream decode of (1, n) tokens -> (1, n*ratio*u) f32 wav:
        one token upload, prompt prefill, the flow (wavefront or per hop),
        then bulk or per-hop vocoding, one fetch."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 2 or tokens.shape[0] != 1:
            raise NotImplementedError("one stream per session; lockstep "
                                      "batches are ROADMAP item A7")
        token_buf = self._token_buf(tokens)
        cache, voc = self.init_state()
        if self.p:
            cache = self._prefill(token_buf, cache)
        plan = self.schedule(tokens.shape[1])
        if bulk_voc and len(plan) >= 2:
            n_steady = sum(1 for _, fin in plan if not fin)
            if wavefront and n_steady >= 2:
                mel, _ = self._flow_mels_wave(token_buf, cache, plan)
            else:
                mel, _ = self._flow_mels(token_buf, cache, plan)
            if self._bulk is None:
                self._bulk = BulkVocoder(self.dec, self.cf)
            wav = self._bulk.vocode(mel, [e * self.ratio for e, _ in plan])
            return wav.cpu().numpy()
        segs = []
        for i, (emit_tokens, finalize) in enumerate(plan):
            mel, cache = self._hop(token_buf, cache, emit_tokens, finalize)
            seg, voc = self._voc(mel, voc, first=i == 0, finalize=finalize)
            segs.append(seg)
        return torch.cat(segs, dim=1).cpu().numpy()
