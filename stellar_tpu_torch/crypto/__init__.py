"""Crypto layer (reference: src/crypto/, SURVEY.md §2.8).

- ``sha``        SHA-256, HMAC, single-step HKDF
- ``keys``       SecretKey / PubKeyUtils + global verify cache
- ``sigcache``   the LRU(65535) memoizer behind all verifies
- ``sigbackend`` batched SigBackend: cpu (libsodium) | gpu (CUDA kernel)
- ``strkey``     base32+CRC16 key encoding
- ``ecdh``       curve25519 session keys for peer auth
- ``sodium``     ctypes ground-truth bindings (pure-Python X25519 and
                 ``os.urandom`` where libsodium does not load)
"""

from .keys import PubKeyUtils, SecretKey, verify_cache  # noqa: F401
from .sha import (  # noqa: F401
    SHA256,
    hkdf_expand,
    hkdf_extract,
    hmac_sha256,
    hmac_sha256_verify,
    sha256,
)
from .sigbackend import (  # noqa: F401
    CachingSigBackend,
    CpuSigBackend,
    DeviceStallError,
    GpuSigBackend,
    SigBackend,
    make_backend,
)
