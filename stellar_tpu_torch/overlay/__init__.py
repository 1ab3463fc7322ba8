"""P2P overlay: authenticated flood/anycast mesh (reference: src/overlay/).

This is the byzantine-tolerant control plane (SURVEY §2.3, §5.8): selector-
driven sockets on the VirtualClock, HMAC-framed XDR messages, flood dedup,
anycast item fetch.  The TPU data plane (batched signature tensors) lives in
``stellar_tpu.crypto.sigbackend`` / ``stellar_tpu.parallel`` — the overlay's
job is only to keep those batches fed.
"""

from .floodgate import Floodgate
from .itemfetcher import ItemFetcher, Tracker
from .loopback import LoopbackPeer, LoopbackPeerConnection
from .manager import OverlayManager
from .peer import Peer, PeerRole, PeerState
from .peerauth import PeerAuth
from .peerrecord import PeerRecord
from .sendqueue import SendQueue, SendQueueStats
from .tcppeer import PeerDoor, TCPPeer

__all__ = [
    "Floodgate", "ItemFetcher", "Tracker", "LoopbackPeer",
    "LoopbackPeerConnection", "OverlayManager", "Peer", "PeerRole",
    "PeerState", "PeerAuth", "PeerRecord", "PeerDoor", "TCPPeer",
    "SendQueue", "SendQueueStats",
]
