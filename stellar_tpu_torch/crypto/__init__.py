"""Crypto layer of the port: the verify plane's backends and what they need.

- ``keys``       SecretKey (seeded keys, signing) + the global verify cache
- ``sigcache``   the LRU(65535) memoizer behind all verifies
- ``sigbackend`` batched SigBackend: cpu (libsodium) | gpu (CUDA kernel)
- ``sodium``     ctypes ground-truth bindings
"""

from .keys import SecretKey, verify_cache  # noqa: F401
from .sigbackend import (  # noqa: F401
    CachingSigBackend,
    CpuSigBackend,
    DeviceStallError,
    GpuSigBackend,
    SigBackend,
    make_backend,
)
