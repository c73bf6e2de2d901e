"""libopus through ctypes (the port's copy of the JAX package's
``serving/opus.py``).

The reference runs the Rust ``sphn`` opus codec on its websocket path
(server.py:3, client.py:5); here the system libopus is driven directly.
The library is looked up at first use: ``available()`` is False where it is
missing, and the codec classes raise ``OSError`` there.

``OpusEncoder.encode`` / ``OpusDecoder.decode`` frame packets with a uint16
big-endian length prefix, a simple framing between two endpoints of this
project; ``serving/ogg.py`` holds the standard Ogg Opus container.  Samples
are numpy float32 arrays; for the same input and controls the packets are
the JAX package's byte for byte.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading
from typing import List, Optional

import numpy as np

OPUS_APPLICATION_VOIP = 2048
OPUS_APPLICATION_AUDIO = 2049
OPUS_GET_LOOKAHEAD_REQUEST = 4027
# encoder CTLs (opus_defines.h)
OPUS_SET_BITRATE_REQUEST = 4002
OPUS_SET_COMPLEXITY_REQUEST = 4010
OPUS_SET_INBAND_FEC_REQUEST = 4012
OPUS_SET_PACKET_LOSS_PERC_REQUEST = 4014
OPUS_SET_DTX_REQUEST = 4016
MAX_PACKET = 4000

_F32P = ctypes.POINTER(ctypes.c_float)
_state = {"lib": None, "tried": False}
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        name = ctypes.util.find_library("opus") or "libopus.so.0"
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            return None
        vp, ci, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.opus_encoder_create.restype = vp
        lib.opus_encoder_create.argtypes = [ci, ci, ci, ip]
        lib.opus_encoder_destroy.restype = None
        lib.opus_encoder_destroy.argtypes = [vp]
        lib.opus_encode_float.restype = ci
        lib.opus_encode_float.argtypes = [vp, _F32P, ci, ctypes.c_char_p, ci]
        # opus_encoder_ctl is variadic: its arguments are wrapped per call
        lib.opus_encoder_ctl.restype = ci
        lib.opus_decoder_create.restype = vp
        lib.opus_decoder_create.argtypes = [ci, ci, ip]
        lib.opus_decoder_destroy.restype = None
        lib.opus_decoder_destroy.argtypes = [vp]
        lib.opus_decode_float.restype = ci
        lib.opus_decode_float.argtypes = [vp, ctypes.c_char_p, ci, _F32P,
                                          ci, ci]
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether libopus can be loaded here."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise OSError("libopus not found (ctypes.util.find_library('opus'), "
                      "libopus.so.0)")
    return lib


class OpusEncoder:
    """float PCM -> opus packets at a fixed frame size (20 ms default).

    Optional knobs (libopus takes 8/12/16/24/48 kHz input):
    ``bitrate`` (bits/s, default libopus auto); ``dtx`` (silence frames
    shrink to 1-2 byte packets); ``fec`` + ``loss_perc`` (in-band forward
    error correction: ``OpusDecoder.decode_fec`` rebuilds a lost frame from
    the next packet); ``complexity`` (0-10)."""

    def __init__(self, sample_rate: int = 24000, channels: int = 1,
                 frame_ms: int = 20, application: int = OPUS_APPLICATION_VOIP,
                 bitrate: Optional[int] = None, dtx: bool = False,
                 fec: bool = False, loss_perc: int = 0,
                 complexity: Optional[int] = None):
        self._l = _lib()
        err = ctypes.c_int(0)
        self.enc = self._l.opus_encoder_create(sample_rate, channels,
                                               application, ctypes.byref(err))
        if err.value != 0 or not self.enc:
            raise RuntimeError(f"opus_encoder_create: {err.value}")
        self.frame = sample_rate * frame_ms // 1000
        self.channels = channels
        self._buf = np.zeros(0, np.float32)
        self._out = ctypes.create_string_buffer(MAX_PACKET)
        for request, value, on in (
                (OPUS_SET_BITRATE_REQUEST, bitrate, bitrate is not None),
                (OPUS_SET_DTX_REQUEST, 1, dtx),
                (OPUS_SET_INBAND_FEC_REQUEST, 1, fec),
                (OPUS_SET_PACKET_LOSS_PERC_REQUEST, loss_perc,
                 bool(loss_perc)),
                (OPUS_SET_COMPLEXITY_REQUEST, complexity,
                 complexity is not None)):
            if on:
                self._ctl(request, value)

    def __del__(self):
        if getattr(self, "enc", None):
            self._l.opus_encoder_destroy(self.enc)
            self.enc = None

    def _ctl(self, request: int, value: int) -> None:
        rc = self._l.opus_encoder_ctl(ctypes.c_void_p(self.enc),
                                      ctypes.c_int(request),
                                      ctypes.c_int(value))
        if rc != 0:
            raise RuntimeError(f"opus_encoder_ctl({request}, {value}): {rc}")

    def lookahead(self) -> int:
        """The encoder's algorithmic delay in samples at the coding rate
        (OPUS_GET_LOOKAHEAD), the Ogg Opus pre-skip."""
        val = ctypes.c_int(0)
        rc = self._l.opus_encoder_ctl(
            ctypes.c_void_p(self.enc),
            ctypes.c_int(OPUS_GET_LOOKAHEAD_REQUEST), ctypes.byref(val))
        return val.value if rc == 0 else 0

    @property
    def pending(self) -> int:
        """Samples buffered towards the next frame."""
        return self._buf.shape[0]

    def encode_packets(self, pcm) -> List[bytes]:
        """Buffers the samples; returns one raw opus packet per complete
        frame (no framing)."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(pcm, np.float32).reshape(-1)])
        n_frames = self._buf.shape[0] // self.frame
        pkts: List[bytes] = []
        for i in range(n_frames):
            chunk = np.ascontiguousarray(
                self._buf[i * self.frame: (i + 1) * self.frame])
            n = self._l.opus_encode_float(self.enc, chunk.ctypes.data_as(_F32P),
                                          self.frame, self._out, MAX_PACKET)
            if n <= 0:
                raise RuntimeError(f"opus_encode_float: {n}")
            pkts.append(self._out.raw[:n])
        self._buf = self._buf[n_frames * self.frame:]
        return pkts

    def encode(self, pcm) -> bytes:
        """Buffers the samples; length-prefixed packets for every complete
        frame."""
        return b"".join(struct.pack(">H", len(p)) + p
                        for p in self.encode_packets(pcm))


class OpusDecoder:
    def __init__(self, sample_rate: int = 24000, channels: int = 1,
                 frame_ms: int = 20):
        self._l = _lib()
        err = ctypes.c_int(0)
        self.dec = self._l.opus_decoder_create(sample_rate, channels,
                                               ctypes.byref(err))
        if err.value != 0 or not self.dec:
            raise RuntimeError(f"opus_decoder_create: {err.value}")
        self.max_frame = sample_rate * 120 // 1000
        self.channels = channels
        self._pending = b""

    def __del__(self):
        if getattr(self, "dec", None):
            self._l.opus_decoder_destroy(self.dec)
            self.dec = None

    def _decode(self, data: Optional[bytes], frame: int, fec: int,
                what: str) -> np.ndarray:
        out = np.empty(frame * self.channels, np.float32)
        got = self._l.opus_decode_float(
            self.dec, data, 0 if data is None else len(data),
            out.ctypes.data_as(_F32P), frame, fec)
        if got <= 0:
            raise RuntimeError(f"opus_decode_float({what}): {got}")
        return out[: got * self.channels]

    def decode_packet(self, pkt: bytes) -> np.ndarray:
        """Decodes ONE raw opus packet (no framing)."""
        return self._decode(pkt, self.max_frame, 0, "packet")

    def decode_fec(self, next_pkt: bytes, frame_samples: int) -> np.ndarray:
        """Rebuilds a LOST frame of ``frame_samples`` from the FOLLOWING
        packet's in-band FEC data (the encoder ran with ``fec=True``);
        falls back to concealment when the packet carries none."""
        return self._decode(next_pkt, frame_samples, 1, "fec")

    def conceal(self, frame_samples: int) -> np.ndarray:
        """Packet-loss concealment: ``frame_samples`` samples for a lost
        packet with no FEC at hand."""
        return self._decode(None, frame_samples, 0, "plc")

    def decode(self, data: bytes) -> np.ndarray:
        """Consumes length-prefixed packets; returns the decoded samples."""
        self._pending += data
        out: List[np.ndarray] = []
        while len(self._pending) >= 2:
            n = struct.unpack(">H", self._pending[:2])[0]
            if len(self._pending) < 2 + n:
                break
            pkt, self._pending = (self._pending[2: 2 + n],
                                  self._pending[2 + n:])
            out.append(self.decode_packet(pkt))
        return (np.concatenate(out) if out else np.zeros(0, np.float32))
