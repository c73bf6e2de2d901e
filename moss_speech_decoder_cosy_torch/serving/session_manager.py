"""Multi-stream serving session manager, after the JAX package's
``serving/session_manager.py``.

The reference serves concurrent TTS/VC streams through CosyVoice2Model's
per-uuid dicts (cosyvoice/cli/model.py: tts_speech_token_dict /
hift_cache_dict keyed by stream uuid, guarded by locks).  Here each stream
owns an independent decoder session (``AudioDecoder.new_session``: its own
prompt, speaker, block size and window), all sharing ONE set of model
weights; the streams' work interleaves on the device queue, so serving N
streams pipelines without lockstep batching.  For homogeneous
high-throughput fan-out use ``AudioDecoder.device_stream_decoder(batch=N)``
instead (lockstep batched hops).

Thread-safe: per-stream state is confined to its handle; the registry is
lock-guarded like the reference's model.py locks.  ``codec`` is kept for
the stream's wire codec; none is needed to decode.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class StreamHandle:
    stream_id: str
    session: object
    sample_rate: int
    emitted_samples: int = 0
    finished: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock)


class MultiStreamManager:
    """Open/push/finish/close lifecycle over shared decoder weights."""

    def __init__(self, decoder, codec=None, max_streams: int = 64):
        self.decoder = decoder
        self.codec = codec
        self.max_streams = max_streams
        self._streams: Dict[str, StreamHandle] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle
    def open(self, stream_id: str, prompt=None,
             block_size: Optional[int] = None,
             max_token_len: Optional[int] = None) -> StreamHandle:
        """Create a stream with its own prompt/speaker and streaming knobs
        (block_size = hop tokens, max_token_len = window bound).  ``prompt``
        has ``token``, ``feat`` and ``embedding`` arrays."""
        with self._lock:
            if stream_id in self._streams:
                raise KeyError(f"stream {stream_id} already open")
            if len(self._streams) >= self.max_streams:
                raise RuntimeError("max_streams reached")
            p_tok = p_feat = p_emb = None
            if prompt is not None:
                p_tok, p_feat, p_emb = (prompt.token, prompt.feat,
                                        prompt.embedding)
            sess = self.decoder.new_session(
                p_tok, p_feat, p_emb, block_size=block_size,
                max_token_len=max_token_len)
            h = StreamHandle(stream_id, sess,
                             self.decoder.pipe_cfg.sample_rate)
            self._streams[stream_id] = h
            return h

    def push(self, stream_id: str, tokens) -> List[np.ndarray]:
        """Feed speech tokens; returns any completed wav chunks."""
        h = self._get(stream_id)
        with h._lock:
            if h.finished:
                raise RuntimeError(f"stream {stream_id} already finished")
            chunks = list(h.session.push(np.asarray(tokens).reshape(-1)))
            h.emitted_samples += sum(c.shape[-1] for c in chunks)
            return chunks

    def finish(self, stream_id: str) -> List[np.ndarray]:
        """Flush the tail with finalize semantics; stream stays queryable
        until close()."""
        h = self._get(stream_id)
        with h._lock:
            if h.finished:
                return []
            chunks = list(h.session.finish())
            h.emitted_samples += sum(c.shape[-1] for c in chunks)
            h.finished = True
            return chunks

    def close(self, stream_id: str) -> None:
        with self._lock:
            self._streams.pop(stream_id, None)

    # ------------------------------------------------------------ queries
    def _get(self, stream_id: str) -> StreamHandle:
        with self._lock:
            return self._streams[stream_id]

    @property
    def active(self) -> List[str]:
        with self._lock:
            return [k for k, h in self._streams.items() if not h.finished]

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {"emitted_samples": h.emitted_samples,
                        "seconds": h.emitted_samples / h.sample_rate,
                        "finished": h.finished}
                    for k, h in self._streams.items()}
