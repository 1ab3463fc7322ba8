"""History archives and their published state
(reference: src/history/HistoryArchive.{h,cpp}).

A HistoryArchive is a remote blob store driven entirely through
user-configured shell command templates (get/put/mkdir) run as subprocesses —
`cp` for local test archives, `curl`/`aws s3` in production.  Its root object
is ``.well-known/stellar-history.json``: a HistoryArchiveState recording the
archive's current ledger and the full 11-level bucket-list shape, including
any in-progress FutureBucket merges (which is what makes merges resumable
across restart).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..bucket.bucket import ZERO_HASH
from ..bucket.futurebucket import FB_CLEAR, FutureBucket

HISTORY_ARCHIVE_STATE_VERSION = 1
WELL_KNOWN_PATH = ".well-known/stellar-history.json"


def _split_hex(hex8: str) -> str:
    return f"{hex8[0:2]}/{hex8[2:4]}/{hex8[4:6]}"


def checkpoint_hex(ledger_seq: int) -> str:
    return f"{ledger_seq:08x}"


def remote_checkpoint_name(category: str, ledger_seq: int, ext: str) -> str:
    """`category/ww/xx/yy/category-<hex8>.<ext>` layout
    (reference: FileTransferInfo.h remoteName)."""
    h = checkpoint_hex(ledger_seq)
    return f"{category}/{_split_hex(h)}/{category}-{h}{ext}"


def remote_bucket_name(bucket_hash: bytes) -> str:
    h = bucket_hash.hex()
    return f"bucket/{_split_hex(h)}/bucket-{h}.xdr.gz"


class HistoryStateBucketLevel:
    """One level of the serialized bucket list: curr/snap hashes + next."""

    def __init__(
        self,
        curr: bytes = ZERO_HASH,
        snap: bytes = ZERO_HASH,
        next_state: Optional[dict] = None,
    ):
        self.curr = curr
        self.snap = snap
        self.next = next_state or {"state": FB_CLEAR}

    def to_json(self) -> dict:
        return {"curr": self.curr.hex(), "snap": self.snap.hex(), "next": self.next}

    @classmethod
    def from_json(cls, d: dict) -> "HistoryStateBucketLevel":
        return cls(
            bytes.fromhex(d.get("curr", ZERO_HASH.hex())),
            bytes.fromhex(d.get("snap", ZERO_HASH.hex())),
            d.get("next", {"state": FB_CLEAR}),
        )


class HistoryArchiveState:
    def __init__(
        self,
        current_ledger: int = 0,
        levels: Optional[List[HistoryStateBucketLevel]] = None,
        server: str = "stellar-tpu",
    ):
        from ..bucket.bucketlist import NUM_LEVELS

        self.version = HISTORY_ARCHIVE_STATE_VERSION
        self.server = server
        self.current_ledger = current_ledger
        self.current_buckets = levels or [
            HistoryStateBucketLevel() for _ in range(NUM_LEVELS)
        ]

    @classmethod
    def from_bucket_list(
        cls, ledger_seq: int, bucket_list, server: str = "stellar-tpu"
    ) -> "HistoryArchiveState":
        levels = [
            HistoryStateBucketLevel(
                lev.curr.get_hash(), lev.snap.get_hash(), lev.next.to_state()
            )
            for lev in bucket_list.levels
        ]
        return cls(ledger_seq, levels, server)

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "server": self.server,
                "currentLedger": self.current_ledger,
                "currentBuckets": [b.to_json() for b in self.current_buckets],
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, s: str) -> "HistoryArchiveState":
        d = json.loads(s)
        st = cls(
            d.get("currentLedger", 0),
            [HistoryStateBucketLevel.from_json(b) for b in d.get("currentBuckets", [])],
            d.get("server", ""),
        )
        st.version = d.get("version", HISTORY_ARCHIVE_STATE_VERSION)
        return st

    def bucket_list_hash(self) -> bytes:
        """The bucketListHash this state reconstructs to, computed from
        hashes alone (BucketList::getHash shape: H(concat H(curr‖snap))) —
        lets catchup validate an archive BEFORE adopting anything."""
        from ..crypto import SHA256

        outer = SHA256()
        for lev in self.current_buckets:
            inner = SHA256()
            inner.add(lev.curr)
            inner.add(lev.snap)
            outer.add(inner.finish())
        return outer.finish()

    def all_bucket_hashes(self) -> List[bytes]:
        """Every nonzero bucket hash referenced (incl. future inputs/outputs)."""
        out: List[bytes] = []
        for lev in self.current_buckets:
            out.append(lev.curr)
            out.append(lev.snap)
            out.extend(FutureBucket.from_state(lev.next).referenced_hashes())
        return [h for h in out if h != ZERO_HASH]

    def differing_buckets(self, other: "HistoryArchiveState") -> List[bytes]:
        """Hashes we reference that ``other`` doesn't (publish delta,
        reference HistoryArchiveState::differingBuckets)."""
        theirs = set(other.all_bucket_hashes())
        seen = set()
        out = []
        for h in self.all_bucket_hashes():
            if h not in theirs and h not in seen:
                seen.add(h)
                out.append(h)
        return out


class HistoryArchive:
    """One configured archive: name + get/put/mkdir command templates with
    ``{0}`` (remote) / ``{1}`` (local) placeholders
    (reference: HistoryArchive.h:166-170)."""

    def __init__(self, name: str, spec: Dict[str, str]):
        self.name = name
        self.get_tmpl = spec.get("get", "")
        self.put_tmpl = spec.get("put", "")
        self.mkdir_tmpl = spec.get("mkdir", "")

    def has_get(self) -> bool:
        return bool(self.get_tmpl)

    def has_put(self) -> bool:
        return bool(self.put_tmpl)

    def has_mkdir(self) -> bool:
        return bool(self.mkdir_tmpl)

    def get_file_cmd(self, remote: str, local: str) -> str:
        return self.get_tmpl.format(remote, local)

    def put_file_cmd(self, local: str, remote: str) -> str:
        # NB: reference putFileCmd substitutes {0}=local {1}=remote
        return self.put_tmpl.format(local, remote)

    def mkdir_cmd(self, remote_dir: str) -> str:
        return self.mkdir_tmpl.format(remote_dir)
