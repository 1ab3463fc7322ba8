"""Per-file transfer bookkeeping for publish/catchup
(reference: src/history/FileTransferInfo.{h,cpp}).

A FileTransferInfo names one checkpoint file in three places: the local
snapshot/staging path, the gzipped staging path, and the remote archive path
(``category/ww/xx/yy/category-<hex8>.xdr.gz``).  The download/upload FSM per
file (FILE_CATCHUP_NEEDED → DOWNLOADING → DOWNLOADED → DECOMPRESSING →
VERIFYING → VERIFIED, CatchupStateMachine.h:78-89) is tracked by the state
machines; this module is just naming + status.
"""

from __future__ import annotations

import os

from .archive import checkpoint_hex, remote_bucket_name, remote_checkpoint_name

CAT_LEDGER = "ledger"
CAT_TRANSACTIONS = "transactions"
CAT_RESULTS = "results"
CAT_BUCKET = "bucket"

# per-file FSM states
FILE_NEEDED = "needed"
FILE_DOWNLOADING = "downloading"
FILE_DOWNLOADED = "downloaded"
FILE_DECOMPRESSING = "decompressing"
FILE_VERIFIED = "verified"
FILE_FAILED = "failed"


class FileTransferInfo:
    def __init__(self, local_dir: str, category: str, base_name: str, remote: str):
        self.category = category
        self.base_name = base_name
        self.local_path = os.path.join(local_dir, base_name)
        self.local_path_gz = self.local_path + ".gz"
        self.remote_name = remote
        self.remote_dir = os.path.dirname(remote)
        self.state = FILE_NEEDED

    @classmethod
    def for_checkpoint(
        cls, local_dir: str, category: str, ledger_seq: int
    ) -> "FileTransferInfo":
        base = f"{category}-{checkpoint_hex(ledger_seq)}.xdr"
        return cls(
            local_dir,
            category,
            base,
            remote_checkpoint_name(category, ledger_seq, ".xdr.gz"),
        )

    @classmethod
    def for_bucket(cls, local_dir: str, bucket_hash: bytes) -> "FileTransferInfo":
        base = f"bucket-{bucket_hash.hex()}.xdr"
        return cls(local_dir, CAT_BUCKET, base, remote_bucket_name(bucket_hash))

    def __repr__(self):
        return f"<FileTransferInfo {self.category} {self.base_name} {self.state}>"
