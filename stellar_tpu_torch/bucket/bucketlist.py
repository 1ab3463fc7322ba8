"""BucketList — 11-level log-structured ledger-state store
(reference: src/bucket/BucketList.{h,cpp}).

Level i holds ~levelSize(i) = 4^(i+1) ledgers of churn in two buckets
{curr, snap}; each level spills into the next when the ledger count crosses
half/size boundaries (levelShouldSpill, BucketList.cpp:186-196).  Merges run
asynchronously on the worker pool as FutureBuckets and are committed (made
curr) the next time the receiving level spills.  The list hash commits to the
whole ledger state: H(concat level hashes), level hash = H(curr ‖ snap)
(BucketList.cpp:29-33,175-181).
"""

from __future__ import annotations

from typing import List

from ..crypto import SHA256
from .bucket import Bucket
from .futurebucket import FutureBucket

NUM_LEVELS = 11  # BucketList.cpp:320


def level_size(level: int) -> int:
    return 1 << (2 * (level + 1))  # 4^(level+1)


def level_half(level: int) -> int:
    return level_size(level) >> 1


def _mask(v: int, m: int) -> int:
    return v & ~(m - 1)


def level_should_spill(ledger: int, level: int) -> bool:
    if level == NUM_LEVELS - 1:
        return False  # the max level never spills
    return ledger == _mask(ledger, level_half(level)) or ledger == _mask(
        ledger, level_size(level)
    )


class BucketLevel:
    def __init__(self, level: int):
        self.level = level
        self.curr = Bucket()
        self.snap = Bucket()
        self.next = FutureBucket()

    def get_hash(self) -> bytes:
        h = SHA256()
        h.add(self.curr.get_hash())
        h.add(self.snap.get_hash())
        return h.finish()

    def commit(self) -> None:
        """Resolve the pending merge into curr (BucketLevel::commit)."""
        if self.next.is_live():
            self.curr = self.next.resolve()
            self.next.clear()

    def prepare(self, app, curr_ledger: int, snap: Bucket, shadows) -> None:
        """Start merging ``snap`` (spilled from the level above) into this
        level's curr (BucketLevel::prepare)."""
        assert not self.next.is_live()
        curr = self.curr
        # Subtle (BucketList.cpp:120-135): if this level's own curr will be
        # snapshotted at its next change-ledger, the incoming material merges
        # into an empty bucket instead — curr is about to be pulled aside.
        if self.level > 0:
            next_change = curr_ledger + level_half(self.level - 1)
            if level_should_spill(next_change, self.level):
                curr = Bucket()
        keep_dead = self.level < NUM_LEVELS - 1
        self.next = FutureBucket(app, curr, snap, list(shadows), keep_dead)

    def take_snap(self) -> Bucket:
        """curr → snap, fresh empty curr; returns the snap (BucketLevel::snap)."""
        self.snap = self.curr
        self.curr = Bucket()
        return self.snap


class BucketList:
    def __init__(self):
        self.levels: List[BucketLevel] = [BucketLevel(i) for i in range(NUM_LEVELS)]

    def get_level(self, i: int) -> BucketLevel:
        return self.levels[i]

    def get_hash(self) -> bytes:
        h = SHA256()
        for lev in self.levels:
            h.add(lev.get_hash())
        return h.finish()

    def add_batch(self, app, curr_ledger: int, live_entries, dead_entries) -> None:
        """One ledger's batch (BucketList::addBatch).  Processes levels
        deepest-first so each curr is snapped the moment it is half full;
        shadows for a level-i merge are the curr/snap of levels 0..i-2
        (see the long comment at BucketList.cpp:214-240 for why i-1's own
        buckets are excluded)."""
        assert curr_ledger > 0
        shadows: List[Bucket] = []
        for lev in self.levels:
            shadows.append(lev.curr)
            shadows.append(lev.snap)
        shadows.pop()
        shadows.pop()
        for i in range(NUM_LEVELS - 1, 0, -1):
            shadows.pop()
            shadows.pop()
            if level_should_spill(curr_ledger, i - 1):
                snap = self.levels[i - 1].take_snap()
                self.levels[i].commit()
                self.levels[i].prepare(app, curr_ledger, snap, shadows)
        assert not shadows
        self.levels[0].prepare(
            app,
            curr_ledger,
            Bucket.fresh(app.bucket_manager, live_entries, dead_entries),
            [],
        )
        self.levels[0].commit()

    def restart_merges(self, app) -> None:
        """Re-launch deserialized in-progress merges (BucketList::restartMerges)."""
        for i, lev in enumerate(self.levels):
            if lev.next.has_hashes():
                lev.next.make_live(app)
