"""Config (reference: src/main/Config.{h,cpp} via cpptoml; here: tomllib).

Same knob set plus the framework's own ``SIGNATURE_BACKEND = "gpu"|"cpu"``
(the north-star selector from BASELINE.json — the reference hardwires
libsodium; we route every verify through the chosen SigBackend, the card's
kernels unless the config asks for libsodium), and
``SIG_DEVICE``, the torch device the gpu backend and the device bucket-hash
backend run on ("cuda", or "cpu" for the kernels' plain versions).
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: stdlib tomllib missing
    try:
        import tomli as tomllib  # the identical pre-3.11 backport, if present
    except ModuleNotFoundError:
        tomllib = None  # Config.load falls back to _parse_minimal_toml
from typing import Dict, List, Optional


def _strip_toml_comment(line: str) -> str:
    """Drop a trailing # comment, respecting quoted strings."""
    in_str = False
    for i, c in enumerate(line):
        if c == '"' and (i == 0 or line[i - 1] != "\\"):
            in_str = not in_str
        elif c == "#" and not in_str:
            return line[:i].strip()
    return line.strip()


def _split_toml_array(inner: str) -> List[str]:
    """Split array elements on commas, respecting quoted strings."""
    parts: List[str] = []
    buf: List[str] = []
    in_str = False
    for i, c in enumerate(inner):
        if c == '"' and (i == 0 or inner[i - 1] != "\\"):
            in_str = not in_str
            buf.append(c)
        elif c == "," and not in_str:
            parts.append("".join(buf).strip())
            buf = []
        else:
            buf.append(c)
    tail = "".join(buf).strip()
    if tail:
        parts.append(tail)
    return [p for p in parts if p]


def _toml_value(v: str, ln: int):
    if v.startswith('"'):
        end = v.find('"', 1)
        while end > 0 and v[end - 1] == "\\":
            end = v.find('"', end + 1)
        if end < 1:
            raise ValueError(f"unterminated string on config line {ln}")
        return v[1:end].replace('\\"', '"')
    if v.startswith("[") and v.endswith("]"):
        return [_toml_value(p, ln) for p in _split_toml_array(v[1:-1])]
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"unparseable config value on line {ln}: {v!r}")


def _parse_minimal_toml(text: str) -> dict:
    """Fallback parser for Python < 3.11 hosts: the flat subset our node
    configs use — `KEY = value` lines, [SECTION] / [SECTION.SUB] tables,
    quoted strings (incl. embedded # and ,), ints, floats, booleans, and
    single-line arrays.  Not a general TOML implementation (no multiline
    arrays/strings, no inline tables) — enough to boot a validator from
    the documented config shape."""
    root: dict = {}
    cur = root
    for ln, raw in enumerate(text.splitlines(), 1):
        line = _strip_toml_comment(raw)
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = root
            for part in line[1:-1].strip().split("."):
                nxt = cur.setdefault(part.strip(), {})
                if not isinstance(nxt, dict):
                    raise ValueError(f"table name collides with a key: {line}")
                cur = nxt
            continue
        if "=" not in line:
            raise ValueError(f"bad config line {ln}: {raw!r}")
        key, _, val = line.partition("=")
        cur[key.strip()] = _toml_value(val.strip(), ln)
    return root

from ..crypto.keys import PubKeyUtils, SecretKey
from ..xdr.scp import SCPQuorumSet
from ..xdr.xtypes import PublicKey


class Config:
    def __init__(self):
        # process / node
        self.FORCE_SCP = False
        self.REBUILD_DB = False
        self.RUN_STANDALONE = False
        self.MANUAL_CLOSE = False
        self.CATCHUP_COMPLETE = False
        self.ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING = False
        self.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = False
        self.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING = False
        self.ALLOW_LOCALHOST_FOR_TESTING = False
        self.FAILURE_SAFETY = 1
        self.UNSAFE_QUORUM = False
        self.LEDGER_PROTOCOL_VERSION = 1
        self.OVERLAY_PROTOCOL_MIN_VERSION = 1
        self.OVERLAY_PROTOCOL_VERSION = 2
        self.VERSION_STR = "stellar-tpu 0.1.0"
        self.LOG_FILE_PATH = ""
        self.TMP_DIR_PATH = "tmp"
        self.BUCKET_DIR_PATH = "buckets"
        self.DESIRED_BASE_FEE = 100
        self.DESIRED_BASE_RESERVE = 100000000
        self.DESIRED_MAX_TX_PER_LEDGER = 500
        self.HTTP_PORT = 39132
        self.PUBLIC_HTTP_PORT = False
        self.NETWORK_PASSPHRASE = ""
        # overlay
        self.PEER_PORT = 39133
        self.TARGET_PEER_CONNECTIONS = 20
        self.MAX_PEER_CONNECTIONS = 50
        self.PREFERRED_PEERS: List[str] = []
        self.KNOWN_PEERS: List[str] = []
        self.PREFERRED_PEER_KEYS: List[str] = []
        self.PREFERRED_PEERS_ONLY = False
        self.MAX_CONCURRENT_SUBPROCESSES = 16
        self.MINIMUM_IDLE_PERCENT = 0
        self.PARANOID_MODE = False
        # TPU-native addition: the overlay survival plane
        # (overlay/sendqueue.py) — every peer owns a bounded,
        # priority-classed outbound queue (CRITICAL > FETCH > FLOOD >
        # GOSSIP); MAC sequence numbers are assigned at DRAIN time so
        # priority reordering and load shedding stay wire-valid.
        # OVERLAY_SENDQ_BYTES caps the total queued bytes per peer
        # (0 = plane off: the reference's unbounded write buffers,
        # bit-exact); FLOOD/GOSSIP shed oldest-within-class under
        # pressure, CRITICAL is never shed — a peer whose CRITICAL
        # head-of-line age exceeds STRAGGLER_STALL_MS, or whose
        # unsheddable backlog exceeds the byte budget, is disconnected
        # with ERR_LOAD and lands in peerrecord backoff.
        self.OVERLAY_SENDQ_BYTES = 2 * 1024 * 1024
        # per-class queued-message cap for the sheddable classes (FLOOD
        # tx broadcast, GOSSIP peer exchange); oldest within the class
        # sheds first
        self.OVERLAY_SENDQ_FLOOD_MSGS = 1024
        # CRITICAL head-of-line stall budget: a consensus-critical frame
        # older than this while still queued marks the peer a straggler
        self.STRAGGLER_STALL_MS = 5000
        # identity / consensus
        self.NODE_SEED: Optional[SecretKey] = None
        self.NODE_IS_VALIDATOR = False
        self.QUORUM_SET = SCPQuorumSet(0, [], [])
        self.VALIDATOR_NAMES: Dict[str, str] = {}
        # history
        self.HISTORY: Dict[str, dict] = {}
        # 64 in production (~5 min at 5s closes); tests accelerate to 8
        # like the reference's accelerated-time mode
        self.CHECKPOINT_FREQUENCY = 64
        # storage
        self.DATABASE = "sqlite3://:memory:"
        self.COMMANDS: List[str] = []
        self.REPORT_METRICS: List[str] = []
        # which SigBackend serves batch verifies: "gpu" (the card's
        # kernels, on SIG_DEVICE) by default; "cpu" is libsodium on the host
        self.SIGNATURE_BACKEND = "gpu"
        self.SIG_BATCH_MAX = 4096
        # multi-chip sharded verify (parallel/mesh.py): shard every packed
        # device chunk over a 1-D batch-axis mesh of addressable chips.
        # 0 = off (single-queue dispatch); "auto" = all addressable
        # devices (falls back to unsharded on a one-chip host); an int
        # pins an exact device count (boot fails when the host has
        # fewer; 1 normalizes to the unsharded single-chip path like a
        # one-chip "auto").  Only meaningful with SIGNATURE_BACKEND =
        # "gpu"; the mesh's devices are of SIG_DEVICE's type and take the
        # place of its index.
        self.SIG_MESH = 0
        # the torch device of the gpu backend and of the device
        # bucket-hash backend: "cuda" runs the kernels (and raises
        # without CUDA); "cpu" runs their plain PyTorch versions (tests)
        self.SIG_DEVICE = "cuda"
        # device-resident verify hash stage (ops/sha512.py): the
        # single-block SHA-512(R‖A‖M) mod L runs ON DEVICE fused ahead
        # of the verify kernel, staging uploads raw bytes and the host
        # keeps only the strict gate (multi-block >111-byte preimages
        # ride the C host stage and merge at the kernel).  Off by
        # default like SIG_MESH — a perf-plane opt-in certified by
        # paired bench legs (rate_host_hash / rate_device_hash);
        # verdicts are bit-exact either way (tests/test_sha512_device).
        # Only meaningful with SIGNATURE_BACKEND = "gpu".
        self.DEVICE_HASH = False
        # device-resident STATE-plane hashing (ops/sha256.py +
        # bucket/hashplane.py): the per-record bucket digests — fresh
        # batches, level-spill merges, selfcheck's full-tree re-hash —
        # run on the batched multi-block SHA-256 kernel instead of the
        # pooled C host stage.  Off by default like DEVICE_HASH: an
        # opt-in certified by the paired bucket_hash bench legs and the
        # relay bucket_hash_r22 A/B gate; hashes are bit-exact across
        # device/native/hashlib backends (tests/test_hashplane.py).
        self.DEVICE_BUCKET_HASH = False
        # level-spill merges run on the dedicated background workers
        # (bucket/mergeworker.py) so the close boundary that commits a
        # spill finds the merge already done.  False = merge
        # synchronously inside prepare() — the bit-exact differential
        # baseline (hashes cannot depend on where the deterministic
        # merge ran) and a single-step debugging crutch.
        self.BACKGROUND_BUCKET_MERGE = True
        # TPU-native addition: which signature scheme serves SCP envelope
        # verification for the quorum set this node faces
        # (crypto/aggregate/).  "ed25519" = the reference per-envelope
        # path through the SigBackend batch plane; "ed25519-halfagg"
        # verifies each slot's ballot bucket as ONE half-aggregation MSM
        # check (falling back to the per-envelope plane for thin buckets
        # and poisoned aggregates), so a node facing thousands of
        # validators pays O(1) aggregate checks per slot instead of N
        # batch lanes.  Verdicts are bit-identical either way
        # (tests/test_halfagg.py differential suite).
        self.SCP_SIG_SCHEME = "ed25519"
        # dispatch streams for multi-chunk verify batches: 2 overlaps one
        # chunk's transport upload with another's execution — worth it
        # only when the accelerator transport pipelines (probe_overlap.py
        # measures; ops/ed25519.py BatchVerifier docs).  The TOML knob
        # wins; its default honors the STELLAR_TPU_VERIFY_STREAMS env var
        # so the documented operator override keeps working on the node
        # path too
        self.SIG_VERIFY_STREAMS = int(
            os.environ.get("STELLAR_TPU_VERIFY_STREAMS", "1")
        )
        # below this many cache-miss verifies the gpu backend loops
        # libsodium instead of paying a device round-trip (default 0:
        # every batch goes to the card; see the constant's definition)
        from ..crypto.sigbackend import DEFAULT_GPU_CPU_CUTOVER

        self.GPU_CPU_CUTOVER = DEFAULT_GPU_CPU_CUTOVER
        # TPU-native addition: structured span tracing (stellar_tpu/trace/).
        # Enabled by default like the reference's always-on medida timers —
        # spans are coarse (per close phase / per sig flush, never per tx),
        # a few µs each.  False short-circuits every instrumented path to a
        # shared no-op before touching the clock or ring (the overhead
        # smoke test in tests/test_trace.py holds that contract).
        self.TRACE_ENABLED = True
        # completed spans kept for /trace; older spans are overwritten
        # (ring wraparound), so memory is bounded regardless of uptime
        self.TRACE_RING_SIZE = 8192
        # TPU-native addition: write-back entry store buffer during ledger
        # close — entry mutations accumulate in an overlay (reads see
        # through it) and flush as batched SQL once per close instead of
        # ~8 statements per applied tx (ledger/storebuffer.py).  Off =
        # reference-style write-through; the differential close tests run
        # both and compare ledger hashes.
        self.ENTRY_WRITE_BUFFER = True
        # TPU-native addition: pluggable ledger-invariant plane
        # (stellar_tpu/invariant/) — close-time safety checks run against
        # the ledger delta + flushed SQL + entry cache BEFORE the commit,
        # so a violation aborts the close instead of persisting a fork.
        # ["all"] (default) enables every registered invariant; [] turns
        # the plane off; individual names pick a subset (see
        # invariant/invariants.py ALL_INVARIANTS).
        self.INVARIANT_CHECKS: List[str] = ["all"]
        # "raise" aborts the violating close (default — the safe mode
        # every test and PARANOID run uses); "log" records + meters the
        # violation and lets the close commit (operator triage)
        self.INVARIANT_FAIL_POLICY = "raise"
        # sampled mode: exact header checks stay exact, per-entry scans
        # cap at INVARIANT_CACHE_SAMPLE seeded-random picks, and the
        # whole-ledger balance sums are skipped.  Sampled is the
        # PRODUCTION default — all-on puts two full-table SUM scans plus
        # per-changed-entry SQL re-reads on every close, which a large
        # ledger cannot pay silently.  Tests run all-on
        # (tx/testutils.get_test_config flips this off) and bench.py
        # measures both modes as invariant_overhead_ms.
        self.INVARIANT_SAMPLED = True
        self.INVARIANT_CACHE_SAMPLE = 16
        # TPU-native addition: close-scoped frame identity map — ONE
        # AccountFrame per touched account per close, shared by fee
        # charging, validity checks, and apply instead of a defensive
        # copy per load (ledger/framecontext.py).  Off = reference-style
        # fresh load per touch; the differential suite
        # (tests/test_framecontext.py) runs both and compares ledger
        # hashes + SQL dumps + history metas.
        self.FRAME_CONTEXT = True
        # TPU-native addition: seal-on-store copy-on-write entry
        # snapshots — EntryFrame._record shares the frame's live entry
        # with the delta / entry cache / store buffer instead of deep-
        # copying per store; the frame pays the copy lazily at its next
        # mutating access (EntryFrame.touch), so entries stored once per
        # close never copy.  Off = eager per-store snapshots; the
        # differential suite (tests/test_framecontext.py) runs both and
        # compares ledger hashes + SQL dumps + history metas.
        self.COW_ENTRY_SNAPSHOTS = True
        # TPU-native addition: pipelined ledger close
        # (ledger/closepipeline.py) — while txset N is in close.apply, the
        # signature prewarm for the already-externalized txset N+1 (and
        # pending SCP envelope batches) dispatches asynchronously through
        # SigBackend.verify_batch_async; N+1's close joins the future at
        # its top, so the device/host verify cost hides inside N's apply
        # wall.  Off = reference-style serial phases; the differential
        # suite (tests/test_framecontext.py, test_closepipeline.py) runs
        # both and compares ledger hashes + SQL dumps + history metas.
        self.CLOSE_PIPELINE = True
        # how many upcoming txsets may hold an in-flight prewarm future at
        # once (the lookahead window; 1 = classic two-stage pipeline)
        self.CLOSE_PIPELINE_DEPTH = 2
        # TPU-native addition: boot self-check & repair
        # (main/selfcheck.py) — verify every durable artifact (bucket
        # file hashes, header chain, persisted SCP state, publish queue)
        # before the ledger loads, quarantining/repairing torn state a
        # killed process left behind.  The crash-survival contract
        # (`python -m stellar_tpu.scenarios --kill-sweep`) depends on
        # it; off is for harnesses that rebuild state wholesale.
        self.SELFCHECK_ON_BOOT = True
        # TPU-native addition: verify-at-ingest admission plane
        # (ingest/plane.py) — submitted (/tx) and flooded (overlay) txs
        # accumulate into size/deadline-bounded micro-batches that ride
        # the SAME SigBackend dispatch as the close path under their own
        # CALLER_INGEST wedge latch; valid verdicts latch into the shared
        # verify cache (close/prewarm flushes read all-hits), invalid-sig
        # txs shed at the edge before check_valid/account loads/flood
        # fan-out.  Off = reference-style per-tx submission; the
        # differential suite (tests/test_ingest.py) runs both and
        # compares ledger hashes.
        self.INGEST_BATCH = True
        # accumulator bounds: flush at INGEST_BATCH_MAX queued txs or
        # INGEST_BATCH_DEADLINE_MS after the first enqueue, whichever
        # comes first (/tx and loadgen submits flush synchronously and
        # carry whatever the overlay has queued along with them)
        self.INGEST_BATCH_MAX = 256
        self.INGEST_BATCH_DEADLINE_MS = 50
        # admission control (0 = off for both): per-source-account
        # token-bucket rate limit (tx/s + burst) and the surge high-water
        # mark — when herder-pending + queued txs reach it, the lowest
        # fee-per-min-fee tx loses its seat (surge_pricing_filter's
        # ordering generalized to the front door); both answer
        # TRY_AGAIN_LATER
        self.INGEST_RATE_LIMIT = 0
        self.INGEST_RATE_BURST = 32
        self.INGEST_SURGE_HIGH_WATER = 0
        # TPU-native addition: conflict-partitioned parallel transaction
        # apply (ledger/applysched.py) — a pre-pass extracts each tx's
        # static account footprint, partitions disjoint-account groups via
        # union-find, and applies groups on worker threads over isolated
        # frame-context/store-buffer shards whose deltas merge back in
        # canonical apply order.  Any tx whose footprint cannot be
        # statically bounded (offers, path payments, inflation, ...) or a
        # shard that trips the footprint-escape assertion falls the whole
        # set back to the serial path — bit-exact either way; the
        # differential suite (tests/test_framecontext.py) runs both and
        # compares ledger hashes + SQL dumps + history metas.  Needs the
        # write-back store buffer (ENTRY_WRITE_BUFFER): shard writes must
        # never reach SQL mid-apply.
        self.PARALLEL_APPLY = True
        # worker threads for the parallel apply path; 0 = auto
        # (os.cpu_count()).  An effective count of 1 short-circuits to
        # the plain serial path with zero scheduling overhead.
        self.APPLY_WORKERS = 0

    # -- loading -----------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Config":
        if tomllib is None:
            with open(path, "r", encoding="utf-8") as f:
                data = _parse_minimal_toml(f.read())
        else:
            with open(path, "rb") as f:
                data = tomllib.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        cfg = cls()
        simple = {
            k
            for k in vars(cfg)
            if k.isupper() and k not in ("NODE_SEED", "QUORUM_SET", "HISTORY")
        }
        for key, value in data.items():
            if key == "NODE_SEED":
                cfg.NODE_SEED = SecretKey.from_strkey_seed(str(value).split()[0])
            elif key == "QUORUM_SET":
                cfg.QUORUM_SET = cls._parse_qset(value)
            elif key == "HISTORY":
                cfg.HISTORY = dict(value)
            elif key in simple:
                setattr(cfg, key, value)
            # unknown keys are ignored like cpptoml does for sections
        cfg.validate()
        return cfg

    @classmethod
    def _parse_qset(cls, spec: dict, level: int = 0) -> SCPQuorumSet:
        """[QUORUM_SET] THRESHOLD=N VALIDATORS=[strkeys...] + nested
        [QUORUM_SET.N] inner sets (Config.cpp loadQset; 2 levels max)."""
        if level > 2:
            raise ValueError("QUORUM_SET nesting deeper than 2")
        qs = SCPQuorumSet(int(spec.get("THRESHOLD", 0)), [], [])
        for v in spec.get("VALIDATORS", []):
            qs.validators.append(PubKeyUtils.from_strkey(str(v).split()[0]))
        for key, sub in spec.items():
            if isinstance(sub, dict):
                qs.innerSets.append(cls._parse_qset(sub, level + 1))
        return qs

    def validate(self) -> None:
        if self.QUORUM_SET.threshold == 0 and (
            self.QUORUM_SET.validators or self.QUORUM_SET.innerSets
        ):
            raise ValueError("QUORUM_SET threshold must be > 0")
        if self.SIGNATURE_BACKEND not in ("cpu", "gpu"):
            raise ValueError(
                f"bad SIGNATURE_BACKEND {self.SIGNATURE_BACKEND!r}: this"
                ' build takes "cpu" or "gpu"'
            )
        if self.SIG_DEVICE not in ("cuda", "cpu") and not str(
            self.SIG_DEVICE
        ).startswith("cuda:"):
            raise ValueError(
                f'SIG_DEVICE must be "cuda", "cuda:N" or "cpu", got'
                f" {self.SIG_DEVICE!r}"
            )
        # a typo'd scheme name must fail the boot, not the first flush
        from ..crypto.aggregate import validate_scheme

        validate_scheme(self.SCP_SIG_SCHEME)
        sm = self.SIG_MESH
        if not (
            sm == 0
            or sm is False
            or sm == "auto"
            or (isinstance(sm, int) and not isinstance(sm, bool) and sm >= 1)
        ):
            raise ValueError(
                f'SIG_MESH must be 0, "auto", or a device count >= 1, '
                f"got {sm!r}"
            )
        dh = self.DEVICE_HASH
        if not (
            isinstance(dh, bool)
            or (isinstance(dh, int) and dh in (0, 1))
        ):
            raise ValueError(
                f"DEVICE_HASH must be a boolean (or 0/1), got {dh!r}"
            )
        for knob in ("DEVICE_BUCKET_HASH", "BACKGROUND_BUCKET_MERGE"):
            v = getattr(self, knob)
            if not (isinstance(v, bool) or v in (0, 1)):
                raise ValueError(
                    f"{knob} must be a boolean (or 0/1), got {v!r}"
                )
        if not (
            isinstance(self.OVERLAY_SENDQ_BYTES, int)
            and not isinstance(self.OVERLAY_SENDQ_BYTES, bool)
            and self.OVERLAY_SENDQ_BYTES >= 0
        ):
            raise ValueError(
                f"OVERLAY_SENDQ_BYTES must be an int >= 0 (0 = off), "
                f"got {self.OVERLAY_SENDQ_BYTES!r}"
            )
        if not (
            isinstance(self.OVERLAY_SENDQ_FLOOD_MSGS, int)
            and not isinstance(self.OVERLAY_SENDQ_FLOOD_MSGS, bool)
            and self.OVERLAY_SENDQ_FLOOD_MSGS >= 1
        ):
            raise ValueError(
                f"OVERLAY_SENDQ_FLOOD_MSGS must be an int >= 1, "
                f"got {self.OVERLAY_SENDQ_FLOOD_MSGS!r}"
            )
        if not (
            isinstance(self.STRAGGLER_STALL_MS, (int, float))
            and not isinstance(self.STRAGGLER_STALL_MS, bool)
            and self.STRAGGLER_STALL_MS > 0
        ):
            raise ValueError(
                f"STRAGGLER_STALL_MS must be a number > 0, "
                f"got {self.STRAGGLER_STALL_MS!r}"
            )
        if not (
            isinstance(self.SIG_VERIFY_STREAMS, int)
            and self.SIG_VERIFY_STREAMS >= 1
        ):
            raise ValueError(
                f"SIG_VERIFY_STREAMS must be an int >= 1, "
                f"got {self.SIG_VERIFY_STREAMS!r}"
            )
        if not (isinstance(self.TRACE_RING_SIZE, int) and self.TRACE_RING_SIZE >= 1):
            raise ValueError(
                f"TRACE_RING_SIZE must be an int >= 1, got {self.TRACE_RING_SIZE!r}"
            )
        # a typo'd invariant name or fail policy must fail the boot, not
        # silently drop a safety check (resolve also re-validates names)
        from ..invariant import FAIL_POLICIES, resolve_invariants

        if not isinstance(self.INVARIANT_CHECKS, list):
            raise ValueError(
                f"INVARIANT_CHECKS must be a list, got {self.INVARIANT_CHECKS!r}"
            )
        resolve_invariants(self.INVARIANT_CHECKS)
        if self.INVARIANT_FAIL_POLICY not in FAIL_POLICIES:
            raise ValueError(
                f"INVARIANT_FAIL_POLICY must be one of {FAIL_POLICIES}, "
                f"got {self.INVARIANT_FAIL_POLICY!r}"
            )
        if not (
            isinstance(self.INVARIANT_CACHE_SAMPLE, int)
            and self.INVARIANT_CACHE_SAMPLE >= 1
        ):
            raise ValueError(
                f"INVARIANT_CACHE_SAMPLE must be an int >= 1, "
                f"got {self.INVARIANT_CACHE_SAMPLE!r}"
            )
        if not (
            isinstance(self.SELFCHECK_ON_BOOT, bool)
            or self.SELFCHECK_ON_BOOT in (0, 1)
        ):
            raise ValueError(
                f"SELFCHECK_ON_BOOT must be a boolean, "
                f"got {self.SELFCHECK_ON_BOOT!r}"
            )
        if not (
            isinstance(self.CLOSE_PIPELINE_DEPTH, int)
            and self.CLOSE_PIPELINE_DEPTH >= 1
        ):
            raise ValueError(
                f"CLOSE_PIPELINE_DEPTH must be an int >= 1, "
                f"got {self.CLOSE_PIPELINE_DEPTH!r}"
            )
        if not (
            isinstance(self.INGEST_BATCH, bool)
            or self.INGEST_BATCH in (0, 1)
        ):
            raise ValueError(
                f"INGEST_BATCH must be a boolean, got {self.INGEST_BATCH!r}"
            )
        if not (
            isinstance(self.INGEST_BATCH_MAX, int)
            and not isinstance(self.INGEST_BATCH_MAX, bool)
            and self.INGEST_BATCH_MAX >= 1
        ):
            raise ValueError(
                f"INGEST_BATCH_MAX must be an int >= 1, "
                f"got {self.INGEST_BATCH_MAX!r}"
            )
        if not (
            isinstance(self.INGEST_BATCH_DEADLINE_MS, (int, float))
            and not isinstance(self.INGEST_BATCH_DEADLINE_MS, bool)
            and self.INGEST_BATCH_DEADLINE_MS >= 0
        ):
            raise ValueError(
                f"INGEST_BATCH_DEADLINE_MS must be a number >= 0, "
                f"got {self.INGEST_BATCH_DEADLINE_MS!r}"
            )
        for knob in (
            "INGEST_RATE_LIMIT",
            "INGEST_RATE_BURST",
            "INGEST_SURGE_HIGH_WATER",
        ):
            v = getattr(self, knob)
            if not (
                isinstance(v, int)
                and not isinstance(v, bool)
                and v >= 0
            ):
                raise ValueError(
                    f"{knob} must be an int >= 0 (0 = off), got {v!r}"
                )
        if not (
            isinstance(self.PARALLEL_APPLY, bool)
            or self.PARALLEL_APPLY in (0, 1)
        ):
            raise ValueError(
                f"PARALLEL_APPLY must be a boolean, got {self.PARALLEL_APPLY!r}"
            )
        if not (
            isinstance(self.APPLY_WORKERS, int)
            and not isinstance(self.APPLY_WORKERS, bool)
            and self.APPLY_WORKERS >= 0
        ):
            raise ValueError(
                f"APPLY_WORKERS must be an int >= 0 (0 = auto), "
                f"got {self.APPLY_WORKERS!r}"
            )

    def to_short_string(self, pk: PublicKey) -> str:
        s = PubKeyUtils.to_strkey(pk)
        return self.VALIDATOR_NAMES.get(s, s[:5])
