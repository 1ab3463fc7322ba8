"""PeerAuth — per-connection session authentication material
(reference: src/overlay/PeerAuth.{h,cpp}).

Each node keeps one ephemeral Curve25519 keypair plus an *auth cert*: the
ephemeral public key and an expiration time, ed25519-signed by the node's
identity key over ``sha256(networkID ‖ ENVELOPE_TYPE_AUTH ‖ expiration ‖
pubkey)`` (PeerAuth.cpp:32-44).  On handshake the peers exchange certs,
verify them (PeerAuth.cpp:72 — one ed25519 verify per connection), run ECDH
over the ephemeral keys, and HKDF-expand the shared key into one HMAC-SHA256
key per direction (PeerAuth.cpp:94-118).
"""

from __future__ import annotations

from ..crypto.ecdh import (
    ecdh_derive_public,
    ecdh_derive_shared_key,
    ecdh_random_secret,
)
from ..crypto.keys import PubKeyUtils
from ..crypto.sha import SHA256, hkdf_expand
from ..xdr.base import xdr_to_opaque
from ..xdr.entries import EnvelopeType
from ..xdr.overlay import AuthCert
from ..xdr.xtypes import Curve25519Public
from ..xdr.base import uint64, xenum

# cert lifetime (PeerAuth.cpp:27: expiration = now + 3600)
AUTH_CERT_LIFETIME_SECONDS = 3600


def _cert_signed_payload(network_id: bytes, expiration: int, pubkey: bytes) -> bytes:
    h = SHA256()
    h.add(network_id)
    h.add(xenum(EnvelopeType).pack(EnvelopeType.ENVELOPE_TYPE_AUTH))
    h.add(uint64.pack(expiration))
    h.add(pubkey)
    return h.finish()


class PeerAuth:
    def __init__(self, app):
        self.app = app
        self._secret = ecdh_random_secret()
        self.public = ecdh_derive_public(self._secret)
        self._cert: AuthCert | None = None

    # -- certs --------------------------------------------------------------
    def get_auth_cert(self) -> AuthCert:
        now = int(self.app.clock.now())
        if self._cert is None or self._cert.expiration < now + AUTH_CERT_LIFETIME_SECONDS // 2:
            expiration = now + AUTH_CERT_LIFETIME_SECONDS
            payload = _cert_signed_payload(self.app.network_id, expiration, self.public)
            sig = self.app.config.NODE_SEED.sign(payload)
            self._cert = AuthCert(Curve25519Public(self.public), expiration, sig)
        return self._cert

    def verify_remote_auth_cert(self, remote_node_id, cert: AuthCert) -> bool:
        """The third ed25519-verify site (PeerAuth.cpp:72)."""
        if cert.expiration < int(self.app.clock.now()):
            return False
        payload = _cert_signed_payload(
            self.app.network_id, cert.expiration, cert.pubkey.key
        )
        return PubKeyUtils.verify_sig(remote_node_id, cert.sig, payload)

    # -- session keys -------------------------------------------------------
    def get_shared_key(self, remote_public: bytes, we_called_remote: bool) -> bytes:
        return ecdh_derive_shared_key(
            self._secret, self.public, remote_public, local_first=we_called_remote
        )

    def get_sending_mac_key(
        self, local_nonce: bytes, remote_nonce: bytes,
        remote_public: bytes, we_called_remote: bool,
    ) -> bytes:
        """HKDF(shared, 0 ‖ localNonce ‖ remoteNonce) for the caller's
        send direction; role byte flips for the acceptor (PeerAuth.cpp:94)."""
        buf = (b"\x00" if we_called_remote else b"\x01") + local_nonce + remote_nonce
        return hkdf_expand(self.get_shared_key(remote_public, we_called_remote), buf)

    def get_receiving_mac_key(
        self, local_nonce: bytes, remote_nonce: bytes,
        remote_public: bytes, we_called_remote: bool,
    ) -> bytes:
        buf = (b"\x01" if we_called_remote else b"\x00") + remote_nonce + local_nonce
        return hkdf_expand(self.get_shared_key(remote_public, we_called_remote), buf)
