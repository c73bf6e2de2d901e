"""Websocket wire protocol, byte-compatible with the reference server
(server.py:14,41-46,91-98) and the JAX package's ``serving/protocol.py``:

  message = kind byte ++ payload
    0x00  handshake (empty payload)
    0x01  audio (opus packets, Ogg pages or pcm16-le samples)
    0x02  text (utf-8)

Audio frames are 1920 samples = 80 ms at 24 kHz.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native

KIND_HANDSHAKE = 0x00
KIND_AUDIO = 0x01
KIND_TEXT = 0x02
FRAME_SAMPLES = 1920            # 80 ms at 24 kHz (server.py:14)
SAMPLE_RATE = 24000


def frame_message(kind: int, payload: bytes = b"") -> bytes:
    return bytes([kind]) + payload


def parse_message(data: bytes) -> Tuple[int, bytes]:
    if not data:
        raise ValueError("empty message")
    return data[0], data[1:]


def pcm16_encode(samples: np.ndarray) -> bytes:
    return native.pcm16_encode(samples)


def pcm16_decode(data: bytes) -> np.ndarray:
    return native.pcm16_decode(data)
