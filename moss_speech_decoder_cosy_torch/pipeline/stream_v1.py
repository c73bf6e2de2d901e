"""CosyVoice-v1 streaming session, after the JAX package's
``pipeline/stream_v1.py`` (reference cli/model.py:29-238).

Each hop re-decodes a bounded token window through the non-causal v1 flow
(``models/flow/flow_v1.py``) and stitches the chunks with Hamming
cross-fades:

- the token hop starts at ``2 * frame_rate`` and grows by
  ``stream_scale_factor`` up to ``4 * frame_rate`` (cli/model.py:44-45,
  200-210); each hop decodes ``token_overlap_len`` (20) more tokens, which
  stay for the next window;
- mel continuity: the CFM's prompt + 34-frame z / mu cache
  (flow_matching.py:44-74) and a ``mel_overlap_len``-frame Hamming
  ``fade_in_out`` between consecutive chunk mels;
- vocoder continuity: the last ``mel_cache_len`` mel frames are vocoded
  again at the next hop with the NSF source overwritten from the cache
  (``HiFTGenerator(cache_source=...)``) and ``source_cache_len`` waveform
  samples cross-faded.

The session runs eagerly on the modules' device; each chunk's mel comes to
the host between the flow and the vocoder, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def fade_in_out(new_head: np.ndarray, old_tail: np.ndarray,
                window: np.ndarray) -> np.ndarray:
    """``new_head[:, :L]`` cross-faded with ``old_tail`` (length L) by a 2L
    Hamming window (utils/common.py:142-150); time is axis 1."""
    ln = window.shape[0] // 2
    shape = (1, ln) + (1,) * (new_head.ndim - 2)
    out = new_head.copy()
    out[:, :ln] = (new_head[:, :ln] * window[:ln].reshape(shape)
                   + old_tail * window[ln:].reshape(shape))
    return out


class StreamSessionV1:
    """Token -> wav streaming for the v1 stack: one request's worth of the
    reference's per-uuid state (cli/model.py:61-66, 186-210).  ``flow`` a
    ``MaskedDiffWithXvec``, ``hift`` a ``HiFTGenerator``, both on one
    device.  ``windows`` lists the token count of each flow forward."""

    def __init__(self, flow, hift, prompt_token: np.ndarray,
                 prompt_feat: np.ndarray, embedding: np.ndarray,
                 sample_rate: int = 22050, mel_hop: int = 256,
                 token_overlap_len: int = 20, mel_cache_len: int = 20,
                 stream_scale_factor: float = 1.0,
                 token_min_hop_len: Optional[int] = None,
                 token_max_hop_len: Optional[int] = None):
        if stream_scale_factor < 1.0:
            raise ValueError(f"stream_scale_factor {stream_scale_factor} "
                             f"< 1")
        fr = flow.cfg.input_frame_rate
        self.flow, self.hift = flow, hift
        self.device = next(flow.parameters()).device
        self.frame_rate = fr
        self.sample_rate = sample_rate
        self.mel_hop = mel_hop
        self.token_min_hop_len = int(token_min_hop_len or 2 * fr)
        self.token_max_hop_len = int(token_max_hop_len or 4 * fr)
        self.token_overlap_len = token_overlap_len
        self.mel_overlap_len = int(token_overlap_len / fr * sample_rate
                                   / mel_hop)
        self.mel_window = np.hamming(
            2 * self.mel_overlap_len).astype(np.float32)
        self.mel_cache_len = mel_cache_len
        self.source_cache_len = mel_cache_len * hift.cfg.total_upsample
        self.speech_window = np.hamming(
            2 * self.source_cache_len).astype(np.float32)
        self.stream_scale_factor = stream_scale_factor

        dev = self.device
        self.prompt_token = torch.as_tensor(
            np.asarray(prompt_token, np.int64)).to(dev)
        self.prompt_feat = torch.as_tensor(
            np.asarray(prompt_feat, np.float32)).to(dev)
        self.embedding = torch.as_tensor(
            np.asarray(embedding, np.float32)).to(dev)

        self.token_hop_len = self.token_min_hop_len
        self.pending: List[int] = []
        self.mel_overlap: Optional[np.ndarray] = None     # (1, L, n_mel)
        self.hift_cache: Optional[dict] = None            # mel, source, speech
        self.flow_cache: Optional[torch.Tensor] = None    # (1, P+34, n_mel, 2)
        self.finished = False
        self.windows: List[int] = []

    @torch.inference_mode()
    def _flow(self, tokens: np.ndarray) -> np.ndarray:
        n = tokens.shape[0]
        mel_len2 = int(n / self.frame_rate * self.sample_rate
                       / self.mel_hop)                    # flow.py:128
        tok = torch.as_tensor(tokens[None].astype(np.int64)).to(self.device)
        mel, self.flow_cache = self.flow.inference(
            tok, self.prompt_token, self.prompt_feat, self.embedding,
            mel_len2, self.flow_cache)
        self.windows.append(n)
        return mel.float().cpu().numpy()

    @torch.inference_mode()
    def _hift(self, mel: np.ndarray, cache_source: np.ndarray):
        dt = next(self.hift.parameters()).dtype
        wav, source = self.hift(
            torch.as_tensor(mel).to(self.device, dt),
            torch.as_tensor(cache_source).to(self.device))
        return wav.float().cpu().numpy(), source.float().cpu().numpy()

    def _token2wav(self, tokens: np.ndarray, finalize: bool) -> np.ndarray:
        """One hop of cli/model.py:133-163 (token2wav)."""
        if tokens.size:
            mel = self._flow(tokens)                      # (1, T, n_mel)
            if self.mel_overlap is not None:
                mel = fade_in_out(mel, self.mel_overlap, self.mel_window)
        else:
            # nothing new to decode: flush the held-back overlap
            mel = (self.mel_overlap if self.mel_overlap is not None
                   else np.zeros((1, 0, self.prompt_feat.shape[-1]),
                                 np.float32))
            self.mel_overlap = None
        if self.hift_cache is not None:
            mel = np.concatenate([self.hift_cache["mel"], mel], axis=1)
            cache_source = self.hift_cache["source"]
        else:
            cache_source = np.zeros((1, 0, 1), np.float32)
        if not finalize and self.mel_overlap_len > 0:
            self.mel_overlap = mel[:, -self.mel_overlap_len:]
            mel = mel[:, :-self.mel_overlap_len]
        wav, source = self._hift(mel, cache_source)
        if self.hift_cache is not None:
            wav = fade_in_out(wav, self.hift_cache["speech"],
                              self.speech_window)
        if not finalize:
            self.hift_cache = {
                "mel": mel[:, -self.mel_cache_len:],
                "source": source[:, -self.source_cache_len:],
                "speech": wav[:, -self.source_cache_len:],
            }
            wav = wav[:, :-self.source_cache_len]
        return wav[0]

    def push_tokens(self, tokens) -> List[np.ndarray]:
        """Feeds speech tokens; returns a wav chunk for every hop filled
        (cli/model.py:196-210)."""
        if self.finished:
            raise RuntimeError("session already finalized")
        self.pending.extend(int(t) for t in np.asarray(tokens).reshape(-1))
        out = []
        while len(self.pending) >= self.token_hop_len + self.token_overlap_len:
            window = np.asarray(
                self.pending[: self.token_hop_len + self.token_overlap_len],
                np.int64)
            out.append(self._token2wav(window, finalize=False))
            del self.pending[: self.token_hop_len]
            self.token_hop_len = min(
                self.token_max_hop_len,
                int(self.token_hop_len * self.stream_scale_factor))
        return out

    def finalize(self) -> np.ndarray:
        """Decodes the remaining tokens as the last chunk
        (cli/model.py:212-221)."""
        if self.finished:
            raise RuntimeError("session already finalized")
        self.finished = True
        window = np.asarray(self.pending, np.int64)
        self.pending = []
        if window.size == 0 and self.hift_cache is None \
                and self.mel_overlap is None:
            return np.zeros((0,), np.float32)
        return self._token2wav(window, finalize=True)
