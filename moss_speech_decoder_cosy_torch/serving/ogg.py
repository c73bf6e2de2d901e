"""Ogg Opus container framing (RFC 3533 Ogg pages + RFC 7845 Opus-in-Ogg),
the port's copy of the JAX package's ``serving/ogg.py``.

The reference streams opus through the Rust ``sphn`` codec, whose wire
format is the standard Ogg Opus stream (server.py:3, client.py:5: sphn's
``OpusStreamWriter``/``OpusStreamReader`` emit and consume Ogg pages).
This module gives the servers that standard container, so they
interoperate with sphn-based clients and any Ogg Opus tool.  For the same
input the pages are the JAX package's byte for byte (the OpusTags vendor
string included).

Dependency-free: pages, lacing, and the Ogg CRC (poly 0x04c11db7, init 0,
no reflection, no final xor) are implemented here; the codec itself is
serving/opus.py (libopus via ctypes).

Layering:
  OggPageWriter / OggPageReader — packets <-> pages (pure container,
    testable without libopus)
  OggOpusWriter / OggOpusReader — PCM <-> Ogg Opus bytes (compose the
    container with OpusEncoder/OpusDecoder)
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Ogg CRC-32: polynomial 0x04c11db7, init 0, forward bit order, no final xor
# (RFC 3533 §6).  NOT zlib's crc32 (which is reflected with init/xor ~0).
# ---------------------------------------------------------------------------

def _make_crc_table():
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if r & 0x80000000 \
                else (r << 1) & 0xFFFFFFFF
        table.append(r)
    return table


_CRC_TABLE = _make_crc_table()


def ogg_crc(data: bytes, crc: int = 0) -> int:
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


# ---------------------------------------------------------------------------
# Page layer
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<4sBBqIII")          # magic..page_seq + crc separate
CONTINUED, BOS, EOS = 0x01, 0x02, 0x04


def _build_page(header_type: int, granule: int, serial: int, seq: int,
                segments: List[bytes]) -> bytes:
    """segments: lacing segments (each <= 255 bytes) in order."""
    assert len(segments) <= 255
    lacing = bytes(len(s) for s in segments)
    payload = b"".join(segments)
    head = (b"OggS" + bytes([0, header_type])
            + struct.pack("<qII", granule, serial, seq)
            + b"\x00\x00\x00\x00"           # crc placeholder
            + bytes([len(segments)]) + lacing)
    crc = ogg_crc(head + payload)
    head = head[:22] + struct.pack("<I", crc) + head[26:]
    return head + payload


def _lace(packet: bytes) -> List[bytes]:
    """Split one packet into lacing segments: 255-byte chunks with a
    terminal chunk < 255 (possibly empty for multiples of 255)."""
    segs = [packet[i: i + 255] for i in range(0, len(packet), 255)]
    if not segs or len(segs[-1]) == 255:
        segs.append(b"")
    return segs


class OggPageWriter:
    """Packets -> Ogg pages.  One page per ``page_out`` call (low-latency
    streaming; sphn likewise flushes per write)."""

    def __init__(self, serial: int = 0x5370_5421):
        self.serial = serial
        self.seq = 0
        self._bos_done = False

    def _emit(self, header_type: int, granule: int,
              segments: List[bytes]) -> bytes:
        if not self._bos_done:
            header_type |= BOS
            self._bos_done = True
        page = _build_page(header_type, granule, self.serial, self.seq,
                           segments)
        self.seq += 1
        return page

    def page_out(self, packets: List[bytes], granule: int,
                 eos: bool = False,
                 granules: Optional[List[int]] = None) -> bytes:
        """Emit the given whole packets as one or more pages ending at
        ``granule``.  Packets longer than 255*255 bytes span pages with the
        CONTINUED flag (RFC 3533 §5).

        ``granules``: per-packet absolute granule positions.  When a page
        fills (255 lacing segments) its header granule must be the granule
        of the LAST packet completed on it (-1 only when none completed,
        RFC 3533 §6); without per-packet granules an intermediate
        packet-aligned page falls back to -1."""
        out = bytearray()
        segs: List[bytes] = []
        cont = 0
        page_last_g: Optional[int] = None   # last completed pkt's granule
        n = len(packets)
        for pi, pkt in enumerate(packets):
            pkt_segs = _lace(pkt)
            for si, s in enumerate(pkt_segs):
                segs.append(s)
                terminal = si == len(pkt_segs) - 1
                if terminal:
                    page_last_g = (granules[pi] if granules is not None
                                   else (granule if pi == n - 1 else None))
                if len(segs) == 255:
                    g = -1 if page_last_g is None else page_last_g
                    out += self._emit(cont, g, segs)
                    segs = []
                    page_last_g = None
                    # CONTINUED only when the flush split a packet
                    cont = 0 if terminal else CONTINUED
        if segs or eos or not out:
            out += self._emit(cont | (EOS if eos else 0), granule, segs)
        return bytes(out)


class OggPageReader:
    """Ogg bytes -> whole packets (incremental; handles packets spanning
    pages via the CONTINUED flag and 255-lacing)."""

    def __init__(self, check_crc: bool = True):
        self._buf = b""
        self._partial = b""
        self.check_crc = check_crc
        self.eos = False

    def packets_in(self, data: bytes) -> List[Tuple[bytes, int]]:
        """Feed bytes; return completed (packet, page_granule) tuples.
        ``page_granule`` is the granule of the page the packet COMPLETED
        on (-1 when the page ended mid-packet)."""
        self._buf += data
        out: List[Tuple[bytes, int]] = []
        while True:
            page = self._next_page()
            if page is None:
                return out
            header_type, granule, segments = page
            if not (header_type & CONTINUED):
                self._partial = b""
            i = 0
            for seg in segments:
                self._partial += seg
                i += 1
                if len(seg) < 255:
                    out.append((self._partial, granule))
                    self._partial = b""
            if header_type & EOS:
                self.eos = True

    def _next_page(self) -> Optional[Tuple[int, int, List[bytes]]]:
        buf = self._buf
        start = buf.find(b"OggS")
        if start < 0:
            self._buf = buf[-3:] if len(buf) > 3 else buf
            return None
        if start:
            buf = buf[start:]
        if len(buf) < 27:
            self._buf = buf
            return None
        n_segs = buf[26]
        if len(buf) < 27 + n_segs:
            self._buf = buf
            return None
        lacing = buf[27: 27 + n_segs]
        body_len = sum(lacing)
        total = 27 + n_segs + body_len
        if len(buf) < total:
            self._buf = buf
            return None
        page, self._buf = buf[:total], buf[total:]
        if self.check_crc:
            crc = struct.unpack("<I", page[22:26])[0]
            zeroed = page[:22] + b"\x00\x00\x00\x00" + page[26:]
            if ogg_crc(zeroed) != crc:
                raise ValueError("ogg page crc mismatch")
        header_type = page[5]
        granule = struct.unpack("<q", page[6:14])[0]
        body = page[27 + n_segs:]
        segments, off = [], 0
        for ln in lacing:
            segments.append(body[off: off + ln])
            off += ln
        return header_type, granule, segments


# ---------------------------------------------------------------------------
# Opus-in-Ogg layer (RFC 7845)
# ---------------------------------------------------------------------------

def opus_head(channels: int = 1, pre_skip: int = 0,
              input_rate: int = 24000, gain_q8: int = 0) -> bytes:
    return (b"OpusHead" + bytes([1, channels])
            + struct.pack("<HIh", pre_skip, input_rate, gain_q8)
            + bytes([0]))                   # mapping family 0


def opus_tags(vendor: str = "moss-speech-decoder-cosy-tpu") -> bytes:
    v = vendor.encode()
    return (b"OpusTags" + struct.pack("<I", len(v)) + v
            + struct.pack("<I", 0))


class OggOpusWriter:
    """Float PCM -> Ogg Opus stream bytes.

    Emits the OpusHead BOS page and OpusTags page before the first audio
    page.  Granule positions count 48 kHz samples (RFC 7845 §4) regardless
    of the coding rate."""

    def __init__(self, sample_rate: int = 24000, channels: int = 1,
                 frame_ms: int = 20, serial: int = 0x5370_5421):
        from .opus import OpusEncoder
        self.enc = OpusEncoder(sample_rate, channels, frame_ms)
        self.pages = OggPageWriter(serial)
        # pre-skip covers the encoder lookahead (RFC 7845 §4.2); granule
        # positions count 48 kHz samples INCLUDING the priming samples
        self.pre_skip = self.enc.lookahead() * 48000 // sample_rate
        self._granule = self.pre_skip
        self._per_packet_48k = 48000 * frame_ms // 1000
        self._headers_done = False
        self.sample_rate = sample_rate
        self.channels = channels

    def _headers(self) -> bytes:
        out = self.pages.page_out([opus_head(self.channels, self.pre_skip,
                                             self.sample_rate)], 0)
        out += self.pages.page_out([opus_tags()], 0)
        self._headers_done = True
        return out

    def _audio_pages(self, pkts: List[bytes], eos: bool = False) -> bytes:
        granules = [self._granule + (i + 1) * self._per_packet_48k
                    for i in range(len(pkts))]
        self._granule = granules[-1] if granules else self._granule
        return self.pages.page_out(pkts, self._granule, eos=eos,
                                   granules=granules)

    def encode(self, pcm) -> bytes:
        out = b"" if self._headers_done else self._headers()
        pkts = self.enc.encode_packets(pcm)
        if not pkts:
            return out
        return out + self._audio_pages(pkts)

    def flush(self) -> bytes:
        """Close the logical stream (EOS page; pads the tail frame with
        silence if samples are pending).

        RFC 7845 §4.5: the final page's granule is REDUCED to cover only
        the real (unpadded) samples so compliant decoders trim the
        padding instead of playing trailing silence."""
        out = b"" if self._headers_done else self._headers()
        pending = self.enc.pending
        if pending:
            real_48k = pending * 48000 // self.sample_rate
            pkts = self.enc.encode_packets(
                [0.0] * (self.enc.frame - pending))
            granule = self._granule + real_48k
            out += self.pages.page_out(pkts, granule, eos=True,
                                       granules=[granule] * len(pkts))
        else:
            out += self.pages.page_out([], self._granule, eos=True)
        return out


class OggOpusReader:
    """Ogg Opus stream bytes -> float32 PCM at ``sample_rate``.

    Skips OpusHead/OpusTags, honors pre-skip (scaled from 48 kHz to the
    decode rate)."""

    def __init__(self, sample_rate: int = 24000, channels: int = 1):
        from .opus import OpusDecoder
        self.dec = OpusDecoder(sample_rate, channels)
        self.pages = OggPageReader()
        self._n_header_pkts = 0
        self._skip = 0
        self.sample_rate = sample_rate

    def decode(self, data: bytes) -> np.ndarray:
        out: List[np.ndarray] = []
        for pkt, _granule in self.pages.packets_in(data):
            if self._n_header_pkts == 0:
                if not pkt.startswith(b"OpusHead"):
                    raise ValueError("first ogg packet is not OpusHead")
                pre_skip_48k = struct.unpack("<H", pkt[10:12])[0]
                self._skip = pre_skip_48k * self.sample_rate // 48000
                self._n_header_pkts = 1
                continue
            if self._n_header_pkts == 1:
                self._n_header_pkts = 2    # OpusTags
                continue
            pcm = self.dec.decode_packet(pkt)
            if self._skip:
                drop = min(self._skip, len(pcm))
                pcm = pcm[drop:]
                self._skip -= drop
            out.append(pcm)
        return np.concatenate(out) if out else np.zeros(0, np.float32)
