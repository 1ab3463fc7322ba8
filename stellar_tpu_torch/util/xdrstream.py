"""XDR record-file streams (reference: src/util/XDRStream.h).

RFC 5531 record marking: each record is a 4-byte big-endian length with the
high ('continuation') bit set, followed by the XDR body.  Used for bucket
files and history ledger/tx/result files — byte-compatible with the
reference so bucket hashes agree.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Type

from ..xdr.base import XdrError, codec_of


class XDROutputFileStream:
    """``durable=True`` makes close() fsync the stream before returning
    (crash-safe staging; util/fs.py discipline), with ``point`` naming
    the site's storage kill-points (``<point>:write`` while the payload
    is complete-but-unsynced, ``<point>:staged`` after the fsync)."""

    def __init__(self, path: str, hasher=None, durable: bool = False,
                 point: str = None, ctx=None):
        # streaming writer for a fresh staging path; durability comes
        # from the fsync-on-close below, adoption/rename from the caller
        self._f = open(path, "wb")
        self._path = path
        self._hasher = hasher
        self._durable = durable
        self._point = point
        self._ctx = ctx
        self.bytes_put = 0

    def write_one(self, obj) -> None:
        body = obj.to_xdr()
        if len(body) >= 0x80000000:
            raise XdrError("record too large")
        frame = struct.pack(">I", len(body) | 0x80000000) + body
        self._f.write(frame)
        self.bytes_put += len(frame)
        if self._hasher is not None:
            self._hasher.add(frame)

    def close(self) -> None:
        if self._durable and not self._f.closed:
            from . import fs

            self._f.flush()
            if self._point is not None:
                fs.kill_point(
                    self._point + fs.STAGE_WRITE, path=self._path,
                    ctx=self._ctx,
                )
            os.fsync(self._f.fileno())
            self._f.close()
            if self._point is not None:
                fs.kill_point(
                    self._point + fs.STAGE_STAGED, path=self._path,
                    ctx=self._ctx,
                )
            return
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class XDRInputFileStream:
    def __init__(self, path: str):
        self._f = open(path, "rb")

    def read_one(self, cls) -> Optional[object]:
        hdr = self._f.read(4)
        if not hdr:
            return None
        if len(hdr) < 4:
            raise XdrError("truncated record header")
        sz = struct.unpack(">I", hdr)[0] & 0x7FFFFFFF
        body = self._f.read(sz)
        if len(body) < sz:
            raise XdrError("malformed XDR file: truncated record")
        return codec_of(cls).unpack(body)

    def read_all(self, cls) -> Iterator[object]:
        while True:
            obj = self.read_one(cls)
            if obj is None:
                return
            yield obj

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
