"""Application — the composition root (reference: src/main/ApplicationImpl.cpp).

Owns one VirtualClock slice, the database, and every manager; subsystems find
each other only through this object, which is what lets the simulation run
many Applications in one process on one clock (SURVEY.md §2.11).
"""

from __future__ import annotations

from typing import Optional

from ..bucket.manager import BucketManager
from ..crypto import make_backend, sha256
from ..database.database import Database
from ..history.manager import HistoryManager
from ..ledger.manager import LedgerManager
from ..util import MetricsRegistry, TmpDirManager, VirtualClock, xlog
from .config import Config
from .persistentstate import (
    K_DATABASE_INITIALIZED,
    K_FORCE_SCP_ON_NEXT_LAUNCH,
    PersistentState,
)

log = xlog.logger("Ledger")


class AppState:
    BOOTING = "Booting"
    CONNECTED = "Connected standby"
    ACQUIRING_CONSENSUS = "Joining SCP"
    CATCHING_UP = "Catching up"
    SYNCED = "Synced!"


class Application:
    def __init__(
        self,
        clock: VirtualClock,
        config: Config,
        new_db: bool = False,
        auto_init: bool = True,
    ):
        self.clock = clock
        self.config = config
        if not config.NETWORK_PASSPHRASE:
            raise ValueError("NETWORK_PASSPHRASE not configured")
        self.network_id = sha256(config.NETWORK_PASSPHRASE.encode())
        self.metrics = MetricsRegistry(clock)
        # span tracer (stellar_tpu/trace/): phase attribution for ledger
        # close / sig flushes / SCP rounds / overlay fetches; aggregates
        # fold into self.metrics as trace.<name> histograms
        from ..trace import Tracer

        self.tracer = Tracer(
            enabled=config.TRACE_ENABLED,
            ring_size=config.TRACE_RING_SIZE,
            clock=clock,
            metrics=self.metrics,
        )
        self.database = Database(config.DATABASE, self.metrics)
        # seal-on-store CoW entry snapshots (ledger/entryframe.py): the
        # knob rides the Database object because EntryFrame._record has
        # db, not config, in hand (same pattern as the entry cache /
        # store buffer / frame context planes)
        self.database._cow_entry_snapshots = config.COW_ENTRY_SNAPSHOTS
        self.persistent_state = PersistentState(self.database)
        self.tmp_dirs = TmpDirManager(config.TMP_DIR_PATH)
        # the SIGNATURE_BACKEND knob: every batch verify in the node flows
        # through this object (and the shared verify cache)
        # (the gpu backend runs on config.SIG_DEVICE: "cuda", or "cpu"
        # for the kernels' plain versions; it builds its kernels here)
        self.sig_backend = make_backend(
            config.SIGNATURE_BACKEND,
            max_batch=config.SIG_BATCH_MAX,
            sig_mesh=config.SIG_MESH,
            device=config.SIG_DEVICE,
            device_hash=bool(config.DEVICE_HASH),
            cpu_cutover=config.GPU_CPU_CUTOVER,
            streams=config.SIG_VERIFY_STREAMS,
            tracer=self.tracer,
        )
        # the device bucket-hash backend (DEVICE_BUCKET_HASH) resolves on
        # the same device; resolving it now builds its kernel before the
        # first bucket is hashed
        if config.DEVICE_BUCKET_HASH:
            from ..bucket import hashplane

            hashplane.get_backend(config)
        # the SCP_SIG_SCHEME knob (crypto/aggregate/): how the overlay's
        # per-crank envelope flush and the herder's eager checks dispatch
        # — per-envelope through sig_backend (the reference path) or
        # slot-bucketed half-aggregation with sig_backend as the
        # non-aggregatable fallback
        from ..crypto.aggregate import make_scheme
        from ..crypto.keys import verify_cache

        self.scp_scheme = make_scheme(
            config.SCP_SIG_SCHEME,
            self.sig_backend,
            verify_cache(),
            tracer=self.tracer,
        )
        # ledger-invariant plane (stellar_tpu/invariant/): close-time
        # safety checks driven by LedgerManager, reported via /invariants
        from ..invariant import InvariantManager

        self.invariants = InvariantManager(self)
        # close-pipeline scheduler (ledger/closepipeline.py): overlaps the
        # signature plane's verify for ledger N+1 with ledger N's apply —
        # LedgerManager consults it only when Config.CLOSE_PIPELINE is on
        from ..ledger.closepipeline import ClosePipeline

        self.close_pipeline = ClosePipeline(self)
        self.bucket_manager = BucketManager(self)
        self.ledger_manager = LedgerManager(self)
        self.history_manager = HistoryManager(self)
        self.herder = None  # attached by create() once built
        self.overlay_manager = None
        self.command_handler = None
        self.process_manager = None
        self.ingest = None  # verify-at-ingest admission plane (create())
        # boot self-check report (main/selfcheck.py), served on /selfcheck
        self.last_selfcheck: Optional[dict] = None
        # per-node wall-clock skew seam (chaos plane): maps the
        # shared clock's reading to THIS node's offset in seconds, so a
        # multi-node simulation can model clock skew/drift/NTP-jumps per
        # validator while every timer still rides the one shared clock.
        # None = no skew (production, and every node by default).  Only
        # time_now() — the WALL-time view (closeTime nomination, the
        # MAX_TIME_SLIP_SECONDS gate) — consults it; durations and timer
        # deadlines are clock-relative and must not skew.
        self.clock_offset_fn = None

        if new_db or (auto_init and self._needs_initialization()):
            # offline utility modes (--info/--loadxdr) pass auto_init=False:
            # they must report an uninitialized DB, not silently create one
            # (reference: checkInitialized, src/main/main.cpp:176-195)
            self.initialize_db()

    # -- creation ----------------------------------------------------------
    @classmethod
    def create(cls, clock: VirtualClock, config: Config, new_db: bool = False):
        app = cls(clock, config, new_db=new_db)
        from ..herder.herder import Herder
        from ..ingest import IngestPlane
        from ..overlay.manager import OverlayManager
        from ..process.manager import ProcessManager
        from .commandhandler import CommandHandler

        app.process_manager = ProcessManager(app)
        app.overlay_manager = OverlayManager(app)
        app.herder = Herder(app)
        # admission front door: every tx submission edge (/tx, overlay
        # flood, loadgen, catchup replay) routes through here
        app.ingest = IngestPlane(app)
        app.command_handler = CommandHandler(app)
        return app

    def _needs_initialization(self) -> bool:
        try:
            return self.persistent_state.get_state(K_DATABASE_INITIALIZED) != "true"
        except Exception:
            return True

    def initialize_db(self) -> None:
        self.database.initialize()
        self.persistent_state.set_state(K_DATABASE_INITIALIZED, "true")
        self.ledger_manager.start_new_ledger()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Load LCL, start overlay, maybe force SCP (ApplicationImpl::start)."""
        # fail fast on a misconfigured quorum set before joining consensus
        # (reference: ApplicationImpl.cpp:230-240)
        cfg = self.config
        if self.herder is not None:
            if cfg.QUORUM_SET.threshold == 0:
                raise ValueError("Quorum not configured")
            if cfg.NODE_IS_VALIDATOR and not self.herder.is_quorum_set_sane(
                cfg.NODE_SEED.get_public_key(), cfg.QUORUM_SET
            ):
                raise ValueError(
                    "Invalid QUORUM_SET: bad threshold or validator is not"
                    " a member"
                )
        if self.persistent_state.get_state(K_DATABASE_INITIALIZED) == "true":
            # crash-and-corruption survival: verify + repair the durable
            # state (tmp reap accounting, publish queue, SCP state,
            # header chain, bucket file hashes) BEFORE anything loads or
            # trusts it — quarantined buckets become "missing" so the
            # archive repair below re-fetches them (main/selfcheck.py)
            if self.config.SELFCHECK_ON_BOOT:
                from .selfcheck import run_boot_selfcheck

                self.last_selfcheck = run_boot_selfcheck(self)
            if self.ledger_manager.last_closed is None:
                self.ledger_manager.load_last_known_ledger()
            # drain any checkpoints queued before a crash/restart — the
            # publish queue is DB-persisted exactly so this can resume
            # (reference: publishQueuedHistory on start)
            self.clock.post(self.history_manager.publish_queued_history)
        force = (
            self.config.FORCE_SCP
            or self.persistent_state.get_state(K_FORCE_SCP_ON_NEXT_LAUNCH) == "true"
        )
        if self.herder is not None:
            # ALWAYS restore the last SCP statements first — even a force
            # -started node must rebroadcast them so a peer that missed the
            # externalize can close the previous ledger (the reference
            # restores before the FORCE_SCP bootstrap,
            # ApplicationImpl.cpp:254,263-279; HerderTests "SCP State"
            # depends on it)
            self.herder.restore_scp_state()
            if force:
                if (
                    self.persistent_state.get_state(K_FORCE_SCP_ON_NEXT_LAUNCH)
                    == "true"
                ):
                    # one-shot flag, cleared once used (ApplicationImpl.cpp:268)
                    self.persistent_state.set_state(
                        K_FORCE_SCP_ON_NEXT_LAUNCH, "false"
                    )
                self.herder.bootstrap()
        if self.overlay_manager is not None and not self.config.RUN_STANDALONE:
            self.overlay_manager.start()
        if self.command_handler is not None:
            self.command_handler.start()

    def graceful_stop(self) -> None:
        if self.ingest is not None:
            # drain the admission accumulator FIRST: every queued
            # submitter gets an answer while the herder can still take
            # the admitted ones
            self.ingest.shutdown()
        if self.herder is not None:
            # cancel consensus timers before anything closes: on a shared
            # simulation clock a dead node's trigger/rebroadcast timer
            # would otherwise fire against a closed database
            self.herder.shutdown()
        if self.overlay_manager is not None:
            self.overlay_manager.shutdown()
        if self.command_handler is not None:
            self.command_handler.stop()
        if self.process_manager is not None:
            self.process_manager.shutdown()
        self.database.close()

    def time_now(self) -> int:
        """Current time as unix seconds on this app's clock
        (Application::timeNow), through the per-node skew seam: a
        simulation-installed ``clock_offset_fn`` shifts THIS node's
        wall-time view (closeTime proposals, the MAX_TIME_SLIP_SECONDS
        acceptance gate) without touching the shared clock's timers."""
        now = self.clock.now()
        off = self.clock_offset_fn
        if off is not None:
            now += off(now)
        return int(now)

    # -- cross-subsystem notifications -------------------------------------
    def herder_notify_ledger_closed(self) -> None:
        if self.herder is not None:
            self.herder.ledger_closed()

    def request_catchup(self) -> None:
        if self.herder is not None:
            self.herder.lost_sync()
        # catchup FSM started by the herder/history integration

    def get_state(self) -> str:
        lm = self.ledger_manager
        from ..ledger.manager import LedgerState

        if lm.last_closed is None:
            return AppState.BOOTING
        if lm.state == LedgerState.LM_CATCHING_UP_STATE:
            return AppState.CATCHING_UP
        if lm.state == LedgerState.LM_SYNCED_STATE:
            return AppState.SYNCED
        return AppState.CONNECTED
