"""Pipeline / session layer: token -> waveform, offline and windowed
streaming, after the JAX package's ``pipeline/audio_decoder.py`` (reference
GLM_modules/flow_inference.py:48-243):

- ``token2wav``           offline decode
- ``StreamSession.push``  chunked streaming over a sliding token window with
                          the HiFT mel/source/speech caches and Hamming
                          cross-fades
- ``device_stream_decoder`` the same windowed semantics kept on the device
- ``kv_stream_decoder``   the KV-cached streaming session, B lockstep
                          streams
- ``kv_batcher``          the continuous batcher, concurrent streams
- ``spmd_decoder``        lockstep streams split over several devices

Model work runs on the decoder's device (CUDA unless ``device="cpu"``);
session state (token buffer, offsets, HiFT caches) is host-side numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.flow import CausalMaskedDiffWithXvec
from ..models.hift import HiFTGenerator
from ..models.hift.generator import DrawFn, linear_interpolate
from ..utils.config import FlowConfig, HiFTConfig, PipelineConfig
from ..utils.device import resolve_device


def fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray,
                window: np.ndarray) -> np.ndarray:
    """Cross-fade the head of ``fade_in`` with the tail of ``fade_out``
    (flow_inference.py:35-43), on the last axis."""
    n = window.shape[0] // 2
    out = np.array(fade_in)
    out[..., :n] = (fade_in[..., :n] * window[:n]
                    + fade_out[..., -n:] * window[n:])
    return out


@dataclasses.dataclass
class HiftCache:
    """Per-session vocoder continuity state (flow_inference.py:150-156)."""
    mel: np.ndarray          # (1, mel_cache_len, n_mel)
    source: np.ndarray       # (1, source_cache_len, 1)
    speech: np.ndarray       # (1, source_cache_len)


class AudioDecoder:
    """Owns the flow and HiFT modules on one device; sessions are cheap.

    ``flow_state`` / ``hift_state`` are state dicts of
    ``CausalMaskedDiffWithXvec(flow_cfg)`` / ``HiFTGenerator(hift_cfg)``
    (``weights.py`` makes them from JAX params, or from a seed).
    ``compute_dtype`` casts every floating parameter; ``estimator_dtype``
    then overrides the CFM estimator's dtype (the bf16-encoder /
    f32-estimator hybrid).  ``nsf_draws`` replaces the HiFT source's
    default random draws."""

    def __init__(self, flow_cfg: FlowConfig, hift_cfg: HiFTConfig,
                 flow_state: Mapping[str, torch.Tensor],
                 hift_state: Mapping[str, torch.Tensor],
                 pipe_cfg: PipelineConfig = PipelineConfig(),
                 compute_dtype: Optional[torch.dtype] = None,
                 estimator_dtype: Optional[torch.dtype] = None,
                 device=None, nsf_draws: Optional[DrawFn] = None):
        self.device = resolve_device(device)
        if estimator_dtype is not None:
            flow_cfg = dataclasses.replace(
                flow_cfg, cfm=dataclasses.replace(
                    flow_cfg.cfm,
                    estimator_dtype=str(estimator_dtype).split(".")[-1]))
        self.flow_cfg = flow_cfg
        self.hift_cfg = hift_cfg
        self.pipe_cfg = pipe_cfg
        self.compute_dtype = compute_dtype
        self.estimator_dtype = estimator_dtype
        with torch.device("meta"):
            flow = CausalMaskedDiffWithXvec(flow_cfg)
            hift = HiFTGenerator(hift_cfg)
        flow.load_state_dict(flow_state, strict=True, assign=True)
        hift.load_state_dict(hift_state, strict=True, assign=True)
        self.flow = flow.to(self.device).eval()
        self.hift = hift.to(self.device).eval()
        if compute_dtype is not None:
            self.flow.to(compute_dtype)
            self.hift.to(compute_dtype)
            if estimator_dtype is not None:
                self.flow.decoder.estimator.to(estimator_dtype)
        if nsf_draws is not None:
            self.hift.draws = nsf_draws
        self.ratio = flow_cfg.token_mel_ratio
        self.lookahead = flow_cfg.pre_lookahead_len
        self.source_cache_len = pipe_cfg.mel_cache_len * hift_cfg.total_upsample
        self.speech_window = np.hamming(2 * self.source_cache_len)

    def _dt(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def _tensor(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    # ---------------------------------------------------------- flow step
    @torch.inference_mode()
    def _flow_mel(self, token: np.ndarray, prompt_token: np.ndarray,
                  prompt_feat: np.ndarray, embedding: np.ndarray,
                  streaming: bool, finalize: bool) -> np.ndarray:
        """Returns the mel AFTER the prompt region, (B, Tm, n_mel) f32."""
        b = token.shape[0]
        if prompt_token.shape[0] == 1 and b > 1:     # shared prompt
            prompt_token = np.broadcast_to(
                prompt_token, (b,) + prompt_token.shape[1:])
            prompt_feat = np.broadcast_to(
                prompt_feat, (b,) + prompt_feat.shape[1:])
            embedding = np.broadcast_to(embedding, (b,) + embedding.shape[1:])
        tokens = np.concatenate([prompt_token, token], axis=1)
        tok = self._tensor(tokens, torch.long)
        valid = torch.ones(tok.shape, dtype=torch.bool, device=self.device)
        mel = self.flow(tok, valid, self._tensor(prompt_feat, self._dt()),
                        self._tensor(embedding, self._dt()),
                        streaming=streaming, finalize=finalize)
        return mel[:, prompt_feat.shape[1]:].float().cpu().numpy()

    @torch.inference_mode()
    def _hift(self, mel: np.ndarray, cache_source: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        wav, source = self.hift(self._tensor(mel, self._dt()),
                                self._tensor(cache_source, self._dt()))
        return (wav.float().cpu().numpy(), source.float().cpu().numpy())

    # ------------------------------------------------------------ offline
    def token2wav(self, token: np.ndarray,
                  prompt_token: Optional[np.ndarray] = None,
                  prompt_feat: Optional[np.ndarray] = None,
                  embedding: Optional[np.ndarray] = None,
                  speed: float = 1.0) -> np.ndarray:
        """Offline decode: (B, T) int tokens -> (B, T*ratio*frame) wav.
        ``speed != 1`` linearly resamples the mel before vocoding."""
        prompt_token, prompt_feat, embedding = self._defaults(
            prompt_token, prompt_feat, embedding)
        mel = self._flow_mel(token, prompt_token, prompt_feat, embedding,
                             streaming=False, finalize=True)
        if speed != 1.0:
            mel = linear_interpolate(torch.from_numpy(mel),
                                     int(mel.shape[1] / speed)).numpy()
        wav, _ = self._hift(mel, np.zeros((1, 0, 1), np.float32))
        return wav

    def _defaults(self, prompt_token, prompt_feat, embedding):
        if prompt_token is None:
            prompt_token = np.zeros((1, 0), np.int32)
        if prompt_feat is None:
            prompt_feat = np.zeros((1, 0, self.flow_cfg.output_size),
                                   np.float32)
        if embedding is None:
            embedding = np.zeros((1, self.flow_cfg.spk_embed_dim), np.float32)
        return prompt_token, prompt_feat, embedding

    # ---------------------------------------------------------- streaming
    def new_session(self, prompt_token=None, prompt_feat=None,
                    embedding=None, block_size: Optional[int] = None,
                    max_token_len: Optional[int] = None) -> "StreamSession":
        prompt_token, prompt_feat, embedding = self._defaults(
            prompt_token, prompt_feat, embedding)
        return StreamSession(
            self, prompt_token, prompt_feat, embedding,
            block_size or self.pipe_cfg.block_size,
            self.pipe_cfg.max_token_len if max_token_len is None
            else max_token_len)

    def stream_inference(self, token: np.ndarray, prompt_token=None,
                         prompt_feat=None, embedding=None,
                         block_size: Optional[int] = None,
                         max_token_len: Optional[int] = None) -> np.ndarray:
        """Reference stream_inference (flow_inference.py:166-243): feed the
        whole token tensor, return the concatenated streamed waveform."""
        sess = self.new_session(prompt_token, prompt_feat, embedding,
                                block_size, max_token_len)
        chunks = list(sess.push(token[0])) + list(sess.finish())
        return np.concatenate(chunks, axis=-1)

    def device_stream_decoder(self, prompt_token=None, prompt_feat=None,
                              embedding=None,
                              block_size: Optional[int] = None,
                              max_token_len: Optional[int] = None,
                              batch: int = 1, graphs: bool = True):
        """Device-resident windowed streaming decoder
        (``device_session.DeviceStreamDecoder``): the reference's windowed
        re-decode with no per-hop host round trip.  ``batch > 1`` decodes
        that many streams in lockstep; ``graphs`` (on a CUDA device)
        replays each step as a CUDA graph, ``graphs=False`` runs the same
        steps eagerly."""
        from .device_session import DeviceStreamDecoder
        prompt_token, prompt_feat, embedding = self._defaults(
            prompt_token, prompt_feat, embedding)
        return DeviceStreamDecoder(
            self, prompt_token, prompt_feat, embedding,
            block_size or self.pipe_cfg.block_size,
            max_token_len or self.pipe_cfg.max_token_len, batch=batch,
            graphs=graphs)

    def kv_stream_decoder(self, prompt_token=None, prompt_feat=None,
                          embedding=None, block_size: Optional[int] = None,
                          ring_tokens: Optional[int] = None,
                          token_cap: int = 2048, batch: int = 1,
                          write_mode: str = "auto",
                          fused: Optional[bool] = None,
                          stacked: bool = False, kernel="auto",
                          ring_quant: bool = False,
                          enc_kernel: bool = False, graphs: bool = True):
        """KV-cached streaming decoder (``kv_session.KVStreamDecoder``):
        every token runs through the flow once; ``ring_tokens`` (default
        max_token_len - block_size) sets the attention's left context.
        ``fused`` selects the write-then-attend wavefront; ``kernel="auto"``
        runs each resnet + transformer group of the estimator as one
        ``fused_tf_group`` launch whenever the geometry allows (True/False
        force it); ``enc_kernel=True`` runs the wavefront's encoder hop with
        each conformer stack as one ``fused_conformer_group`` launch;
        ``graphs`` (on a CUDA device) replays each wavefront iteration and
        each per-hop step as a CUDA graph, ``graphs=False`` runs the same
        steps eagerly.  ``fused=False`` runs the concat dataflow (attention
        over [ring ++ chunk], the chunk written after the estimator);
        ``write_mode="onehot"``, or a ring that is not a multiple of the
        hop, writes each row at its own position instead of one shared
        offset; both run the unfused engine, as in the JAX package.
        ``batch > 1`` decodes that many lockstep streams (tokens (B, T); a
        prompt with a leading dim of 1 is shared by every stream).
        ``ring_quant`` stores the estimator rings as int8 with per-frame
        scales; it runs the concat dataflow, so ``fused`` defaults to True
        without it and to False with it, and ``fused=True`` with it raises.
        ``enc_kernel`` with ``batch > 1`` and ``stacked`` raise."""
        if fused is None:
            fused = not ring_quant
        if stacked:
            raise NotImplementedError("the stacked-scan engine is not "
                                      "ported (measured slower in "
                                      "BENCH_NOTES.md)")
        from .kv_session import KVStreamDecoder
        prompt_token, prompt_feat, embedding = self._defaults(
            prompt_token, prompt_feat, embedding)
        hop = block_size or self.pipe_cfg.block_size
        if ring_tokens is None:
            ring_tokens = self.pipe_cfg.max_token_len - hop
        return KVStreamDecoder(self, prompt_token, prompt_feat, embedding,
                               hop, ring_tokens=ring_tokens,
                               token_cap=token_cap, fused=fused,
                               kernel=kernel, enc_kernel=enc_kernel,
                               graphs=graphs, write_mode=write_mode,
                               batch=batch, ring_quant=ring_quant)

    def replica(self, device) -> "AudioDecoder":
        """This decoder's weights (in their compute dtypes) on ``device``,
        with the same configs and NSF draws."""
        return AudioDecoder(
            self.flow_cfg, self.hift_cfg, self.flow.state_dict(),
            self.hift.state_dict(), self.pipe_cfg,
            compute_dtype=self.compute_dtype,
            estimator_dtype=self.estimator_dtype, device=device,
            nsf_draws=self.hift.draws)

    def spmd_decoder(self, devices: Sequence, prompt_token=None,
                     prompt_feat=None, embedding=None,
                     block_size: Optional[int] = None,
                     ring_tokens: Optional[int] = None,
                     token_cap: int = 2048, batch: Optional[int] = None,
                     **session_kw):
        """Lockstep KV decoding of ``batch`` streams (default one per
        device) split over ``devices`` (``parallel.make_mesh()``, or any
        list; a device may repeat), one replica each
        (``spmd_session.SPMDKVDecoder``): no collective, every replica
        the single-device lockstep session at ``batch / len(devices)``
        streams.  ``session_kw`` as ``kv_stream_decoder``'s."""
        from .spmd_session import SPMDKVDecoder
        return SPMDKVDecoder(self, devices, prompt_token=prompt_token,
                             prompt_feat=prompt_feat, embedding=embedding,
                             block_size=block_size, ring_tokens=ring_tokens,
                             token_cap=token_cap, batch=batch, **session_kw)

    def kv_batcher(self, n_lanes: int = 4, block_size: Optional[int] = None,
                   ring_tokens: Optional[int] = None, token_cap: int = 1024,
                   fused: Optional[bool] = None, ring_quant: bool = False,
                   kernel="auto", graphs: bool = True):
        """Continuous-batching KV decoder (``kv_batcher.KVContinuousBatcher``,
        the JAX package's ``AudioDecoder.kv_batcher``): a pool of
        ``n_lanes`` lanes shares one batched estimator wavefront, and
        streams are admitted and finished at any time.  ``kernel`` as in
        ``kv_stream_decoder`` (the per-row write mode of
        ``fused_tf_group``); ``graphs`` (on a CUDA device) replays the
        wavefront tick, the encoder hop, the first and the batched steady
        vocoder hops and the finalize hop as CUDA graphs.  ``fused=False``
        runs the concat dataflow (the unfused engine); ``ring_quant`` int8
        lane rings on the concat dataflow, so ``fused`` defaults to ``not
        ring_quant`` and ``fused=True`` with it raises."""
        if fused is None:
            fused = not ring_quant
        from .kv_batcher import KVContinuousBatcher
        return KVContinuousBatcher(self, n_lanes=n_lanes,
                                   block_size=block_size,
                                   ring_tokens=ring_tokens,
                                   token_cap=token_cap, fused=fused,
                                   ring_quant=ring_quant, kernel=kernel,
                                   graphs=graphs)


class StreamSession:
    """Incremental token -> wav-chunk session: ``push(tokens)`` yields a wav
    chunk for every complete hop (hop + pre_lookahead tokens);
    ``finish()`` flushes the tail with finalize semantics.  The reference
    loop of flow_inference.py:191-243 with the ``max_token_len`` window."""

    def __init__(self, dec: AudioDecoder, prompt_token: np.ndarray,
                 prompt_feat: np.ndarray, embedding: np.ndarray,
                 block_size: int, max_token_len: Optional[int]):
        self.dec = dec
        self.prompt_token = prompt_token.astype(np.int32)
        self.prompt_feat = prompt_feat.astype(np.float32)
        self.embedding = embedding.astype(np.float32)
        self.hop = block_size
        self.max_token_len = max_token_len
        self.tokens: List[int] = []
        self.token_offset = 0
        self.cache: Optional[HiftCache] = None
        p = prompt_token.shape[1]
        # align the first hop to the hop grid (flow_inference.py:187)
        self.prompt_token_pad = int(math.ceil(p / self.hop) * self.hop - p)

    def _window(self, end: int) -> Tuple[np.ndarray, int]:
        start = (max(0, end - self.max_token_len)
                 if self.max_token_len is not None else 0)
        window = np.asarray(self.tokens[start:end], np.int32)[None, :]
        return window, self.token_offset - start

    def _decode(self, window: np.ndarray, actual_offset: int,
                finalize: bool) -> np.ndarray:
        dec = self.dec
        mel = dec._flow_mel(window, self.prompt_token, self.prompt_feat,
                            self.embedding, streaming=True,
                            finalize=finalize)
        mel = mel[:, actual_offset * dec.ratio:]
        if self.cache is not None:
            mel = np.concatenate([self.cache.mel, mel], axis=1)
            cache_source = self.cache.source
        else:
            cache_source = np.zeros((1, 0, 1), np.float32)
        speech, source = dec._hift(mel, cache_source)
        if self.cache is not None:
            speech = fade_in_out(speech, self.cache.speech,
                                 dec.speech_window)
        scl = dec.source_cache_len
        if not finalize:
            self.cache = HiftCache(
                mel=mel[:, -dec.pipe_cfg.mel_cache_len:],
                source=source[:, -scl:],
                speech=speech[:, -scl:])
            speech = speech[:, :-scl]
        return speech

    def push(self, tokens: Iterable[int]):
        """Append tokens; yield wav chunks for every complete hop."""
        self.tokens.extend(int(t) for t in np.asarray(tokens).reshape(-1))
        while True:
            this_hop = (self.hop + self.prompt_token_pad
                        if self.token_offset == 0 else self.hop)
            if len(self.tokens) - self.token_offset < this_hop + self.dec.lookahead:
                return
            end = self.token_offset + this_hop + self.dec.lookahead
            window, actual_offset = self._window(end)
            speech = self._decode(window, actual_offset, finalize=False)
            self.token_offset += this_hop
            yield speech

    def finish(self):
        """Flush the remaining tokens with finalize=True; a session that
        never received tokens yields nothing."""
        if not self.tokens:
            return
        window, actual_offset = self._window(len(self.tokens))
        yield self._decode(window, actual_offset, finalize=True)
