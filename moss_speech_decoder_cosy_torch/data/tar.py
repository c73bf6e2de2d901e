"""Random access to the members of a tar shard through mmap, after the JAX
package's ``data/tar.py`` (the reference's MMTar / Tar pair,
cosyvoice1/dataset/processor.py:100-156): a plain ``.tar`` of wavs and a
pickled ``.index`` sidecar of (name, header offset, size) triples.

``build_index`` makes the sidecar from a bare tar; the scan applies GNU
long-name ('L') and PAX ``path=`` records to the member that follows and
stops at the zero-block trailer.  Members decode through
``eval.audio_io``."""

from __future__ import annotations

import io
import mmap
import os
import pickle
from typing import Dict, List, Tuple

_BLOCK = 512


def _parse_octal(field: bytes) -> int:
    s = field.split(b"\x00", 1)[0].strip()
    return int(s, 8) if s else 0


class MMTar:
    """An mmap view of a tar archive: a member read at a known offset."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    def close(self):
        m = getattr(self, "_m", None)
        if m is not None and not m.closed:
            m.close()
        f = getattr(self, "_f", None)
        if f is not None:
            f.close()

    def __del__(self):
        self.close()

    def member_at(self, offset: int) -> Tuple[str, bytes]:
        """(name, payload) of the member whose header starts at
        ``offset``."""
        hdr = self._m[offset: offset + _BLOCK]
        name = hdr[0:100].split(b"\x00", 1)[0].decode("utf-8")
        size = _parse_octal(hdr[124:136])
        start = offset + _BLOCK
        return name, self._m[start: start + size]

    def scan(self) -> List[Tuple[str, int, int]]:
        """[(name, header offset, size)] of the regular files, long names
        applied."""
        out = []
        off = 0
        n = len(self._m)
        pending_name = None
        while off + _BLOCK <= n:
            hdr = self._m[off: off + _BLOCK]
            if hdr == b"\x00" * _BLOCK:            # the archive's trailer
                break
            size = _parse_octal(hdr[124:136])
            typeflag = hdr[156:157]
            payload = self._m[off + _BLOCK: off + _BLOCK + size]
            if typeflag == b"L":                   # GNU long name
                pending_name = payload.rstrip(b"\x00").decode("utf-8")
            elif typeflag in (b"x", b"g"):         # PAX records
                for rec in payload.split(b"\n"):
                    if b" " in rec:
                        _, kv = rec.split(b" ", 1)
                        if kv.startswith(b"path="):
                            pending_name = kv[5:].decode("utf-8")
            elif typeflag in (b"0", b"\x00"):
                name = pending_name if pending_name is not None else \
                    hdr[0:100].split(b"\x00", 1)[0].decode("utf-8")
                out.append((name, off, size))
                pending_name = None
            else:
                pending_name = None
            off += _BLOCK + ((size + _BLOCK - 1) // _BLOCK) * _BLOCK
        return out


def _index_path(tar_path: str) -> str:
    root, _ = os.path.splitext(tar_path)
    return root + ".index"


def build_index(tar_path: str, index_path: str = None) -> str:
    """Writes the ``.index`` sidecar (a pickled (name, offset, size)
    list); returns its path."""
    index_path = index_path or _index_path(tar_path)
    t = MMTar(tar_path)
    try:
        entries = t.scan()
    finally:
        t.close()
    with open(index_path, "wb") as f:
        pickle.dump(entries, f)
    return index_path


class IndexedTar:
    """Members by name: reads the ``.index`` sidecar, building it first if
    it is missing.  The sidecar is unpickled, so read only indices this
    code wrote."""

    def __init__(self, tar_path: str):
        self._tar = MMTar(tar_path)
        ipath = _index_path(tar_path)
        if not os.path.exists(ipath):
            build_index(tar_path, ipath)
        with open(ipath, "rb") as f:
            entries = pickle.load(f)
        self._offsets: Dict[str, int] = {e[0]: e[1] for e in entries}

    def names(self):
        return list(self._offsets)

    def read(self, name: str) -> bytes:
        return self._tar.member_at(self._offsets[name])[1]

    def read_wav(self, name: str):
        """A wav member -> (float32 samples, sample rate)."""
        from ..eval.audio_io import read_wav_bytes
        return read_wav_bytes(io.BytesIO(self.read(name)))

    def close(self):
        self._tar.close()
