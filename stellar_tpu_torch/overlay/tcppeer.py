"""TCPPeer / PeerDoor — real-socket transport on the VirtualClock selector
(reference: src/overlay/TCPPeer.{h,cpp}, src/overlay/PeerDoor.{h,cpp}).

Frames are 4-byte big-endian length-prefixed XDR ``AuthenticatedMessage``s.
All socket callbacks run on the clock's crank (the node's single IO thread),
mirroring the reference's asio single-reactor model.
"""

from __future__ import annotations

import errno
import selectors
import socket
from collections import deque
from typing import Deque, Optional

from ..util import xlog
from .peer import Peer, PeerRole

log = xlog.logger("Overlay")

MAX_MESSAGE_SIZE = 16 * 1024 * 1024
HDR_SIZE = 4


class TCPPeer(Peer):
    # the 4-byte length header send_frame prepends: charged by the send
    # queue per frame, credited back through wrote_bytes(n) as the kernel
    # accepts raw wire bytes — charge and credit balance exactly
    FRAME_WIRE_OVERHEAD = HDR_SIZE

    def __init__(self, app, role: str, sock: socket.socket):
        super().__init__(app, role)
        self.sock = sock
        self.sock.setblocking(False)
        self._rbuf = bytearray()
        self._wbuf: Deque[bytes] = deque()
        self._wpos = 0
        self._writing = False
        self._connecting = role == PeerRole.WE_CALLED_REMOTE
        self._closed = False
        self._peer_ip = ""
        try:
            self._peer_ip = sock.getpeername()[0]
        except OSError:
            pass

    # -- connection setup ---------------------------------------------------
    @classmethod
    def initiate(cls, app, ip: str, port: int) -> "TCPPeer":
        """Begin an async connect (TCPPeer::initiate)."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        peer = cls(app, PeerRole.WE_CALLED_REMOTE, s)
        peer._peer_ip = ip
        try:
            s.connect((ip, port))
        except BlockingIOError:
            pass
        except OSError as e:
            log.warning("connect to %s:%d failed: %s", ip, port, e)
            peer.drop()
            return peer
        app.clock.watch(s, selectors.EVENT_WRITE, peer._on_connect_ready)
        return peer

    @classmethod
    def accept(cls, app, sock: socket.socket) -> "TCPPeer":
        peer = cls(app, PeerRole.REMOTE_CALLED_US, sock)
        peer._start_read()
        return peer

    def _on_connect_ready(self, _events) -> None:
        err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err != 0:
            log.info("connect failed: %s", errno.errorcode.get(err, err))
            self.drop()
            return
        self._connecting = False
        self._start_read()
        self.connect_handler()

    # -- IO -----------------------------------------------------------------
    def _wanted_events(self) -> int:
        ev = selectors.EVENT_READ
        if self._wbuf:
            ev |= selectors.EVENT_WRITE
        return ev

    def _start_read(self) -> None:
        if not self._closed:
            self.app.clock.watch(self.sock, self._wanted_events(), self._on_io)

    def _on_io(self, events) -> None:
        if self._closed:
            return
        if events & selectors.EVENT_READ:
            self._do_read()
        if self._closed:
            return
        if events & selectors.EVENT_WRITE:
            self._do_write()
        if not self._closed:
            self.app.clock.watch(self.sock, self._wanted_events(), self._on_io)

    def _do_read(self) -> None:
        try:
            chunk = self.sock.recv(256 * 1024)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            log.info("read error from %r: %s", self, e)
            self.drop()
            return
        if not chunk:
            self.drop()  # EOF
            return
        self.received_bytes()  # partial frames still count as activity
        self._rbuf += chunk
        # decode as many complete frames as arrived; batch SCP pre-warm
        # happens naturally since each recv_frame call runs back-to-back
        while True:
            if len(self._rbuf) < HDR_SIZE:
                break
            ln = int.from_bytes(self._rbuf[:HDR_SIZE], "big")
            if ln > MAX_MESSAGE_SIZE:
                log.warning("oversized frame (%d) from %r", ln, self)
                self.drop()
                return
            if len(self._rbuf) < HDR_SIZE + ln:
                break
            frame = bytes(self._rbuf[HDR_SIZE : HDR_SIZE + ln])
            del self._rbuf[: HDR_SIZE + ln]
            self.recv_frame(frame)
            if self._closed:
                return

    def _do_write(self) -> None:
        # reentrancy guard: wrote_bytes(n) credits the send queue, whose
        # drain may emit a fresh frame -> send_frame -> back here while
        # the outer loop is mid-entry.  The nested call is a no-op; the
        # outer loop picks the appended frames up naturally.
        if self._writing:
            return
        self._writing = True
        try:
            while self._wbuf:
                buf = self._wbuf[0]
                try:
                    n = self.sock.send(buf[self._wpos :])
                except (BlockingIOError, InterruptedError):
                    return
                except OSError as e:
                    log.info("write error to %r: %s", self, e)
                    self.drop()
                    return
                if n > 0:
                    # only bytes accepted by the kernel count as progress
                    # — and they credit the send queue's in-flight window
                    self.wrote_bytes(n)
                self._wpos += n
                if self._wpos >= len(buf):
                    self._wbuf.popleft()
                    self._wpos = 0
        finally:
            self._writing = False

    # -- Peer transport interface -------------------------------------------
    def send_frame(self, data: bytes) -> None:
        if self._closed:
            return
        self._wbuf.append(len(data).to_bytes(HDR_SIZE, "big") + data)
        self._do_write()
        if self._wbuf and not self._closed:
            self.app.clock.watch(self.sock, self._wanted_events(), self._on_io)

    def close_transport(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.app.clock.unwatch(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass

    def ip(self) -> str:
        return self._peer_ip


class PeerDoor:
    """Listening acceptor (PeerDoor.{h,cpp}): hands new sockets to
    TCPPeer.accept and registers them as pending peers."""

    def __init__(self, app):
        self.app = app
        self.sock: Optional[socket.socket] = None

    def start(self) -> None:
        cfg = self.app.config
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.setblocking(False)
        s.bind(("0.0.0.0", cfg.PEER_PORT))
        s.listen(64)
        self.sock = s
        self.app.clock.watch(s, selectors.EVENT_READ, self._on_accept)
        log.info("listening for peers on :%d", cfg.PEER_PORT)

    def _on_accept(self, _events) -> None:
        while True:
            try:
                conn, addr = self.sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            om = self.app.overlay_manager
            if om is None or om.is_shutting_down():
                conn.close()
                return
            peer = TCPPeer.accept(self.app, conn)
            om.add_pending_peer(peer)

    def close(self) -> None:
        if self.sock is not None:
            self.app.clock.unwatch(self.sock)
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
