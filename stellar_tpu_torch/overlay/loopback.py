"""LoopbackPeer — in-process peer pair for tests and simulation
(reference: src/overlay/LoopbackPeer.{h,cpp}).

A pair of Peers whose transports are each other's in-memory queues, with
fault injection: per-message drop / duplicate / reorder / byte-damage
probabilities, cork control, queue bounding, and a lossy/latency delivery
mode — the byzantine test rig (LoopbackPeer.h:24-100).  Delivery is
explicit (``deliver_one`` / ``deliver_all``) or scheduled on the clock, so
tests and the Simulation can crank message-by-message deterministically;
with ``latency`` set, scheduled delivery rides a VirtualTimer instead of
the next crank, modeling a slow link under the same (virtual or real)
clock.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

from ..util import VirtualTimer, xlog
from ..xdr.overlay import MessageType
from .peer import Peer, PeerRole

log = xlog.logger("Overlay")

MAX_QUEUE_DEPTH = 1000


@dataclass
class FaultProfile:
    """One link side's fault knobs, as the chaos plane schedules them
    (stellar_tpu/scenarios/faults.py).  ``latency`` is seconds of delivery
    delay on the link; ``drain`` is a byte-rate cap (bytes/sec, 0 =
    unlimited) modeling a SLOW READER — scheduled pumps deliver at most
    their interval's byte budget and leave the rest queued, so the
    sender's transport backs up exactly like a peer that stops reading
    its socket; the probabilistic knobs map 1:1 onto the LoopbackPeer
    attributes of the same name.  NOTE: post-handshake, any
    drop/duplicate/reorder/damage that actually fires breaks the peers'
    MAC sequence and costs the CONNECTION (exactly like losing bytes
    inside a TCP stream) — a lossy profile therefore models link FLAPS,
    and liveness comes from the scenario's link doctor re-establishing
    the pair plus SCP rebroadcast.  A pure drain cap delivers whole
    frames in order and never flaps."""

    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    damage: float = 0.0
    latency: float = 0.0
    drain: float = 0.0

    def apply(self, peer: "LoopbackPeer", seed: Optional[int] = None) -> None:
        peer.drop_prob = self.drop
        peer.duplicate_prob = self.duplicate
        peer.reorder_prob = self.reorder
        peer.damage_prob = self.damage
        peer.latency = self.latency
        peer.drain_rate = self.drain
        if seed is not None:
            # scenario-scoped determinism: the per-process ctor nonce makes
            # pairs uncorrelated but NOT replayable across two runs in one
            # process — a chaos run reseeds every armed peer from its own
            # seed space so the same fault program rolls the same faults
            peer._rng = random.Random(seed)


class LoopbackPeer(Peer):
    # per-process construction counter feeding the fault-roll seed (see
    # __init__): same construction order => same rolls, pairs uncorrelated
    _ctor_nonce = 0

    def __init__(self, app, role: str):
        super().__init__(app, role)
        self.remote: Optional["LoopbackPeer"] = None
        self.out_queue: Deque[bytes] = deque()
        self.corked = False
        self.max_queue_depth = MAX_QUEUE_DEPTH
        # fault injection (LoopbackPeer.h:36-41)
        self.damage_prob = 0.0
        self.drop_prob = 0.0
        self.duplicate_prob = 0.0
        self.reorder_prob = 0.0
        self.damage_cert = False
        self.damage_auth = False
        # lossy/latency delivery mode: >0 delays each scheduled pump by
        # this many (clock) seconds — frames sent while the pump is armed
        # ride the same delayed batch, the "slow link" shape
        self.latency = 0.0
        # slow-reader mode: >0 caps delivery at this many bytes/sec —
        # each scheduled pump spends one interval's byte budget and the
        # remainder waits, so the transport genuinely backs up (the shape
        # the send queue's shed/straggler plane defends against)
        self.drain_rate = 0.0
        self._drain_tokens = 0.0  # deficit-carrying byte budget (see _pump)
        self._latency_timer: Optional[VirtualTimer] = None
        self._latency_armed = False
        # seeded: fault-injection rolls (drop/damage/reorder) must replay
        # identically so a chaos run that found a bug can be re-run
        # (determinism rule; probabilities default 0.0, so the seed is
        # inert outside fault-injection tests).  Role bit + per-process
        # construction nonce: the two sides of a pair AND distinct pairs
        # in one topology all roll independent sequences, while the same
        # construction order replays the same faults run-to-run.
        LoopbackPeer._ctor_nonce += 1
        self._rng = random.Random(
            0x100BBAC0
            ^ (1 if role == PeerRole.WE_CALLED_REMOTE else 2)
            ^ (LoopbackPeer._ctor_nonce << 8)
        )
        self._closed = False

    # -- transport ----------------------------------------------------------
    def send_frame(self, data: bytes) -> None:
        if self._closed or self.remote is None:
            return
        self.out_queue.append(data)
        if not self.send_queue.active:
            # legacy bounded transport (knob-off only): indiscriminate
            # shed-oldest at depth.  With the survival plane on, the
            # class-aware SendQueue is the bounding layer and its
            # in-flight window keeps this deque small — shedding frames
            # that already consumed a MAC sequence number here would
            # break the receiver's sequence check.
            while len(self.out_queue) > self.max_queue_depth:
                self.out_queue.popleft()
        if not self.corked:
            self._schedule_delivery()

    def close_transport(self) -> None:
        self._closed = True
        remote = self.remote
        if remote is not None and not remote._closed:
            # async close notification, as a socket EOF would be
            self.app.clock.post(lambda: remote.drop())

    def ip(self) -> str:
        return "127.0.0.1"

    # -- explicit delivery (tests) ------------------------------------------
    def deliver_one(self) -> bool:
        """Move one queued frame into the remote peer, applying faults."""
        if self.remote is None or not self.out_queue:
            return False
        entry = self.out_queue.popleft()
        # entries re-queued by a fault are marked stale so the duplicate /
        # reorder faults can't recurse and delivery always terminates
        data, fresh = entry if isinstance(entry, tuple) else (entry, True)
        # like TCPPeer (which stamps on kernel-accepted bytes), write
        # progress is stamped when a frame actually moves on the "wire" —
        # a peer whose output only ever piles into a shedding queue makes
        # no progress and must trip the idle write timeout;
        # the byte count credits the send queue's in-flight window.
        # Fault-requeued (stale) entries were charged to the window only
        # ONCE, so only the fresh pass credits it — a double credit would
        # over-open the window and drift the transport bound.
        self.wrote_bytes(len(data) if fresh else 0)

        if self.drop_prob > 0 and self._rng.random() < self.drop_prob:
            log.debug("loopback dropping frame")
            return True
        if fresh and self.duplicate_prob > 0 and (
            self._rng.random() < self.duplicate_prob
        ):
            log.debug("loopback duplicating frame")
            self.out_queue.append((data, False))
        if fresh and self.reorder_prob > 0 and len(self.out_queue) > 0 and (
            self._rng.random() < self.reorder_prob
        ):
            log.debug("loopback reordering frame")
            self.out_queue.append((data, False))
            return True
        if self.damage_prob > 0 and self._rng.random() < self.damage_prob:
            log.debug("loopback damaging frame")
            data = self._flip_random_byte(data)
        # targeted handshake damage (LoopbackPeer.h:83-100), applied at
        # delivery so tests can arm the knobs after the connection starts
        mt = self._frame_msg_type(data)
        if self.damage_cert and mt == MessageType.HELLO2:
            data = self._damage_hello2_cert(data)
        if self.damage_auth and mt == MessageType.AUTH:
            data = self._flip_random_byte(data)

        remote = self.remote
        if remote is not None and not remote._closed:
            remote.recv_frame(data)
        return True

    def deliver_all(self) -> None:
        while self.deliver_one():
            pass

    def drop_all(self) -> None:
        self.out_queue.clear()

    # pump cadence for a drain-limited link with no latency set: the
    # byte budget per pump window is drain_rate * interval
    DRAIN_TICK = 0.05

    def _schedule_delivery(self) -> None:
        if self.latency > 0 or self.drain_rate > 0:
            if self._latency_armed:
                return  # queued frames ride the already-armed pump
            if self._latency_timer is None:
                self._latency_timer = VirtualTimer(self.app.clock)
            self._latency_armed = True
            self._latency_timer.expires_from_now(
                self.latency if self.latency > 0 else self.DRAIN_TICK
            )
            self._latency_timer.async_wait(self._latency_pump)
        else:
            self.app.clock.post(self._pump)

    def _latency_pump(self) -> None:
        self._latency_armed = False
        self._pump()
        # frames that arrived while this pump ran (or that a fault
        # re-queued, or that the drain cap left behind) wait a fresh
        # window, like bytes behind a slow link's send buffer
        if self.out_queue and not self.corked and not self._closed:
            self._schedule_delivery()

    def _pump(self) -> None:
        if self.corked:
            return
        if self.drain_rate > 0:
            # slow reader: token bucket with deficit carry — each window
            # adds rate*interval tokens; a frame bigger than one window's
            # quantum drives the balance negative and later windows pay
            # the debt off, so the AVERAGE rate equals the configured
            # bytes/sec regardless of frame size (no per-tick
            # at-least-one-frame under-throttle).  Whole frames, in
            # order, never faulted by the cap itself.
            interval = self.latency if self.latency > 0 else self.DRAIN_TICK
            quantum = self.drain_rate * interval
            self._drain_tokens += quantum
            if not self.out_queue:
                # idle links must not bank unbounded burst credit
                self._drain_tokens = min(self._drain_tokens, quantum)
            while self.out_queue and self._drain_tokens > 0:
                head = self.out_queue[0]
                data, fresh = (
                    head if isinstance(head, tuple) else (head, True)
                )
                if fresh:
                    # fault-requeued (stale) entries were billed on
                    # their first pass — mirroring the wrote_bytes
                    # fresh-only credit below, or a reorder/duplicate
                    # fault under a drain cap would double-charge the
                    # budget and sink the link below its configured rate
                    self._drain_tokens -= len(data)
                if not self.deliver_one():
                    break
        else:
            self.deliver_all()

    def set_corked(self, corked: bool) -> None:
        self.corked = corked
        if not corked:
            self._schedule_delivery()

    @staticmethod
    def _damage_hello2_cert(data: bytes) -> bytes:
        """Corrupt the auth-cert signature inside a HELLO2 frame."""
        from ..xdr.overlay import AuthenticatedMessage

        try:
            amsg = AuthenticatedMessage.from_xdr(data)
            cert = amsg.value.message.value.cert
            sig = bytearray(cert.sig)
            sig[0] ^= 0x01
            cert.sig = bytes(sig)
            return amsg.to_xdr()
        except Exception:
            return data

    @staticmethod
    def _frame_msg_type(data: bytes):
        """StellarMessage type inside an XDR AuthenticatedMessage frame:
        union disc (4) + sequence (8) + message type (4)."""
        if len(data) < 16:
            return None
        try:
            return MessageType(int.from_bytes(data[12:16], "big"))
        except ValueError:
            return None

    def _flip_random_byte(self, data: bytes) -> bytes:
        if not data:
            return data
        i = self._rng.randrange(len(data))
        b = bytearray(data)
        b[i] ^= 1 << self._rng.randrange(8)
        return bytes(b)


class LoopbackPeerConnection:
    """Wires an initiator/acceptor LoopbackPeer pair between two apps and
    kicks off the handshake (LoopbackPeer.cpp LoopbackPeerConnection)."""

    def __init__(self, initiator_app, acceptor_app):
        self.initiator = LoopbackPeer(initiator_app, PeerRole.WE_CALLED_REMOTE)
        self.acceptor = LoopbackPeer(acceptor_app, PeerRole.REMOTE_CALLED_US)
        self.initiator.remote = self.acceptor
        self.acceptor.remote = self.initiator
        initiator_app.overlay_manager.add_pending_peer(self.initiator)
        acceptor_app.overlay_manager.add_pending_peer(self.acceptor)
        self.initiator.connect_handler()
