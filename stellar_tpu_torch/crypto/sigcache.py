"""Global ed25519 verification cache (reference: src/crypto/SecretKey.cpp:29-52).

Pure-function memoization: key = SHA256(pubkey ‖ sig ‖ msg) → bool.  The
reference guards a 65,535-entry LRU with a mutex; we do the same (the lock
also covers the GPU backend's batch scatter-back, which may run off-thread).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Tuple


class VerifySigCache:
    def __init__(self, capacity: int = 0xFFFF):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._map: OrderedDict[bytes, bool] = OrderedDict()  # analysis: locked-by _lock
        self._hits = 0
        self._misses = 0

    @staticmethod
    def key_for(pubkey_raw: bytes, signature: bytes, msg: bytes) -> bytes:
        h = hashlib.sha256()
        h.update(pubkey_raw)
        h.update(signature)
        h.update(msg)
        return h.digest()

    def get(self, key: bytes) -> Tuple[bool, bool]:
        """Returns (hit, value)."""
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                self._hits += 1
                return True, self._map[key]
            self._misses += 1
            return False, False

    def peek_many(self, keys) -> list:
        """Batch lookup WITHOUT counting misses (used by the batch verifier
        to split a batch into cached/uncached without double-counting)."""
        out = []
        with self._lock:
            for k in keys:
                if k in self._map:
                    self._map.move_to_end(k)
                    self._hits += 1
                    out.append(self._map[k])
                else:
                    out.append(None)
        return out

    def put(self, key: bytes, value: bool) -> None:
        with self._lock:
            self._map[key] = value
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def put_many(self, pairs) -> None:
        with self._lock:
            for key, value in pairs:
                self._map[key] = value
                self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def drop_many(self, keys) -> None:
        """Evict entries (quarantine path: verdicts latched by an async
        flush whose close was aborted are withdrawn — see
        SigFlushFuture.quarantine)."""
        with self._lock:
            for k in keys:
                self._map.pop(k, None)

    def flush_counts(self) -> Tuple[int, int]:
        with self._lock:
            h, m = self._hits, self._misses
            self._hits = self._misses = 0
            return h, m

    def clear(self) -> None:
        with self._lock:
            self._map.clear()

    def __len__(self):
        with self._lock:
            return len(self._map)
