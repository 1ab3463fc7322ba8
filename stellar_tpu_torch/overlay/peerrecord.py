"""PeerRecord: SQL-backed peer address book (reference: src/overlay/PeerRecord.*).

peers table with backoff (numfailures -> exponential nextattempt) and ranking;
the overlay tick picks non-preferred peers from here ordered by nextattempt.
"""

from __future__ import annotations

import ipaddress
from typing import List, Optional

MAX_NUM_FAILURES = 10
SECONDS_PER_BACKOFF = 10


class PeerRecord:
    def __init__(self, ip: str, port: int, next_attempt: float = 0.0, num_failures: int = 0):
        self.ip = ip
        self.port = int(port)
        self.next_attempt = next_attempt
        self.num_failures = num_failures

    # -- parsing (PeerRecord::parseIPPort) ---------------------------------
    @classmethod
    def parse_ip_port(cls, s: str, default_port: int = 39133) -> "PeerRecord":
        host, _, port_s = s.partition(":")
        port = int(port_s) if port_s else default_port
        if not (0 < port <= 65535):
            raise ValueError(f"bad port in {s!r}")
        ipaddress.ip_address(host)  # raises on non-IP (no DNS here, like tests)
        return cls(host, port)

    def to_string(self) -> str:
        return f"{self.ip}:{self.port}"

    def is_localhost(self) -> bool:
        """127/8 loopback (PeerRecord::isLocalhost)."""
        try:
            return ipaddress.ip_address(self.ip).is_loopback
        except ValueError:
            return False

    def is_self_address_and_port(self, ip: str, port: int) -> bool:
        """PeerRecord::isSelfAddressAndPort — remote-supplied lists can echo
        an endpoint back at its owner."""
        return self.ip == ip and self.port == port

    def is_private_address(self) -> bool:
        """RFC1918 check, exactly the reference's ranges
        (PeerRecord.cpp:213-229): 10/8, 172.16/12, 192.168/16.  NOT
        ipaddress.is_private — that also counts 127/8 and link-local,
        and loopback/TCP tests legitimately exchange 127.0.0.1."""
        try:
            val = int(ipaddress.IPv4Address(self.ip))
        except (ipaddress.AddressValueError, ValueError):
            return False
        return (
            (val >> 24) == 10
            or (val >> 20) == 2753
            or (val >> 16) == 49320
        )

    # -- SQL ---------------------------------------------------------------
    @staticmethod
    def drop_all(db) -> None:
        db.execute("DROP TABLE IF EXISTS peers")
        db.execute(
            """CREATE TABLE peers (
                ip          VARCHAR(15) NOT NULL,
                port        INT DEFAULT 0 CHECK (port > 0 AND port <= 65535) NOT NULL,
                nextattempt TIMESTAMP NOT NULL,
                numfailures INT DEFAULT 0 CHECK (numfailures >= 0) NOT NULL,
                PRIMARY KEY (ip, port)
            )"""
        )

    @classmethod
    def load(cls, db, ip: str, port: int) -> Optional["PeerRecord"]:
        row = db.query_one(
            "SELECT nextattempt, numfailures FROM peers WHERE ip=? AND port=?",
            (ip, port),
        )
        return cls(ip, port, row[0], row[1]) if row else None

    @classmethod
    def load_peers(cls, db, max_num: int, next_attempt_cutoff: float) -> List["PeerRecord"]:
        rows = db.query_all(
            "SELECT ip, port, nextattempt, numfailures FROM peers"
            " WHERE nextattempt <= ? ORDER BY nextattempt ASC, numfailures ASC LIMIT ?",
            (next_attempt_cutoff, max_num),
        )
        return [cls(*r) for r in rows]

    def insert_if_new(self, db) -> bool:
        """Store ONLY when the (ip, port) is unknown (PeerRecord::insertIfNew):
        remote-supplied data must never clobber the backoff/next-attempt
        state we already track for a known peer."""
        if (
            db.query_one(
                "SELECT 1 FROM peers WHERE ip=? AND port=?", (self.ip, self.port)
            )
            is not None
        ):
            return False
        return self.store(db)

    def store(self, db) -> bool:
        """Insert-or-update; returns True if newly inserted."""
        existed = (
            db.query_one(
                "SELECT 1 FROM peers WHERE ip=? AND port=?", (self.ip, self.port)
            )
            is not None
        )
        db.execute(
            "INSERT INTO peers (ip, port, nextattempt, numfailures) VALUES (?,?,?,?)"
            " ON CONFLICT(ip, port) DO UPDATE SET"
            " nextattempt=excluded.nextattempt, numfailures=excluded.numfailures",
            (self.ip, self.port, self.next_attempt, self.num_failures),
        )
        return not existed

    def back_off(self, db, now: float) -> None:
        """Exponential backoff on failure (PeerRecord::backOff)."""
        self.num_failures += 1
        self.next_attempt = now + SECONDS_PER_BACKOFF * min(
            2 ** min(self.num_failures, MAX_NUM_FAILURES), 256
        )
        self.store(db)

    def reset_back_off(self, db, now: float) -> None:
        self.num_failures = 0
        self.next_attempt = now
        self.store(db)

    @staticmethod
    def delete(db, ip: str, port: int) -> None:
        db.execute("DELETE FROM peers WHERE ip=? AND port=?", (ip, port))
