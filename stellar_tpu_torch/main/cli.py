"""CLI entry point (reference: src/main/main.cpp:53-71,289).

Flags mirror the reference binary:

  --conf FILE     config file (TOML); default stellar-tpu.cfg
  --newdb         create a fresh database (genesis) and exit
  --newhist NAME  initialize the named history archive and exit
  --forcescp      set the force-SCP-on-next-launch DB flag and exit
  --genseed       print a random node seed + public key and exit
  --convertid ID  print an id (strkey/hex) in every representation
  --dumpxdr FILE  pretty-print an XDR record file
  --genfuzz FILE  write random fuzzer corpus seeds
  --fuzz FILE     replay a fuzz file into a loopback node pair
  --c CMD         send an admin command to a running node (HTTP)
  --info          print node status from the database and exit
  --loadxdr FILE  load an XDR bucket file into the database (testing)
  --ll LEVEL      log level (trace/debug/info/warning/error)
  --metric NAME   report this metric on exit (repeatable)
  --test [ARGS]   run the test suite (pytest passthrough)
  (no flag)       run the node: crank the clock until stopped

The run loop is the reference's `while (!io.stopped()) clock.crank(true)`
(main.cpp:279-285).
"""

from __future__ import annotations

import json
import signal
import sys

from ..util import xlog


def _usage() -> str:
    return __doc__


def _print_id_representations(arg: str) -> int:
    from ..crypto import strkey

    out = {}
    try:
        ver, payload = strkey.from_strkey(arg)
        out["strkey"] = arg
        out["hex"] = payload.hex()
        out["version"] = ver
    except Exception:
        try:
            raw = bytes.fromhex(arg)
            if len(raw) != 32:
                raise ValueError("hex id must be 32 bytes")
            out["hex"] = arg
            out["account strkey"] = strkey.to_account_strkey(raw)
        except Exception:
            print(f"unparseable id {arg!r}", file=sys.stderr)
            return 1
    for k, v in out.items():
        print(f"{k}: {v}")
    return 0


def _gen_seed() -> int:
    from ..crypto.keys import SecretKey

    sk = SecretKey.random()
    print(f"Secret seed: {sk.get_strkey_seed()}")
    print(f"Public: {sk.get_strkey_public()}")
    return 0


def _dump_xdr(path: str) -> int:
    """Record type chosen by filename prefix, like dumpxdr.cpp."""
    import os

    from ..util.xdrstream import XDRInputFileStream
    from ..xdr.ledger import (
        BucketEntry,
        LedgerHeaderHistoryEntry,
        TransactionHistoryEntry,
        TransactionHistoryResultEntry,
    )
    from ..xdr.overlay import StellarMessage
    from ..xdr.scp import SCPEnvelope
    from ..xdr.txs import TransactionEnvelope

    name = os.path.basename(path)
    by_prefix = {
        "bucket": BucketEntry,
        "ledger": LedgerHeaderHistoryEntry,
        "transactions": TransactionHistoryEntry,
        "results": TransactionHistoryResultEntry,
        "scp": SCPEnvelope,
        "tx": TransactionEnvelope,
    }
    cls = StellarMessage
    for prefix, c in by_prefix.items():
        if name.startswith(prefix):
            cls = c
            break
    with XDRInputFileStream(path) as f:
        i = 0
        for rec in f.read_all(cls):
            print(f"[{i}] {rec}")
            i += 1
        print(f"({i} {cls.__name__} records)")
    return 0


def _send_command(cfg, cmd: str) -> int:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", cfg.HTTP_PORT, timeout=30)
    try:
        conn.request("GET", cmd if cmd.startswith("/") else "/" + cmd)
        resp = conn.getresponse()
        print(resp.read().decode())
        return 0 if resp.status == 200 else 1
    finally:
        conn.close()


def _new_hist(cfg, names) -> int:
    """Initialize archives with a genesis HistoryArchiveState
    (reference: --newhist / HistoryManager::initializeHistoryArchive)."""
    import subprocess
    import tempfile

    from ..history.archive import WELL_KNOWN_PATH, HistoryArchive, HistoryArchiveState

    for name in names:
        spec = cfg.HISTORY.get(name)
        if spec is None:
            print(f"no such archive {name!r} in config", file=sys.stderr)
            return 1
        ar = HistoryArchive(name, spec)
        if not ar.has_put():
            print(f"archive {name!r} has no put command", file=sys.stderr)
            return 1
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            f.write(HistoryArchiveState(0).to_json())
            local = f.name
        if ar.has_mkdir():
            subprocess.run(ar.mkdir_cmd(".well-known"), shell=True, check=False)
        r = subprocess.run(ar.put_file_cmd(local, WELL_KNOWN_PATH), shell=True)
        if r.returncode != 0:
            print(f"initializing archive {name!r} failed", file=sys.stderr)
            return 1
        print(f"initialized archive {name!r}")
    return 0


def _set_force_scp(cfg, value: bool = True) -> int:
    from ..database.database import Database
    from .persistentstate import K_FORCE_SCP_ON_NEXT_LAUNCH, PersistentState

    db = Database(cfg.DATABASE)
    PersistentState(db).set_state(
        K_FORCE_SCP_ON_NEXT_LAUNCH, "true" if value else "false"
    )
    db.close()
    print(f"force-SCP flag set to {value}")
    return 0


def _with_offline_app(cfg, fn) -> int:
    """Run fn(app) against the existing database, without starting the
    overlay/herder (reference: checkInitialized + offline helpers,
    src/main/main.cpp:176-213)."""
    from ..util.clock import VIRTUAL_TIME, VirtualClock
    from .application import Application

    clock = VirtualClock(VIRTUAL_TIME)
    app = Application(clock, cfg, auto_init=False)
    try:
        if app._needs_initialization():
            print("Database is not initialized", file=sys.stderr)
            return 1
        if app.ledger_manager.last_closed is None:
            app.ledger_manager.load_last_known_ledger()
        return fn(app)
    finally:
        app.graceful_stop()
        clock.shutdown()


def _report_info(cfg) -> int:
    """--info (reference: main.cpp:420 -> Application::reportInfo)."""
    from .commandhandler import CommandHandler

    def report(app):
        app.command_handler = CommandHandler(app)
        print(json.dumps(app.command_handler.handle_info({}), indent=1))
        return 0

    return _with_offline_app(cfg, report)


def _load_xdr(cfg, bucket_file: str) -> int:
    """--loadxdr (reference: main.cpp:198-213 loadXdr): apply an XDR bucket
    file's entries to the database, for testing."""
    import hashlib
    import os

    from ..bucket.bucket import Bucket

    if not os.path.exists(bucket_file):
        print(f"no such file: {bucket_file}", file=sys.stderr)
        return 1

    def load(app):
        # a default-constructed Bucket(path) has the zero hash, which means
        # "empty" — hash the file (streamed; hashlib.file_digest is 3.11+
        # but we support 3.10) so apply actually replays it
        h = hashlib.sha256()
        with open(bucket_file, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        digest = h.digest()
        Bucket(bucket_file, hash=digest).apply(app.database)
        print(f"applied {bucket_file}")
        return 0

    return _with_offline_app(cfg, load)


def _run_node(cfg, new_db: bool, metrics) -> int:
    from ..util.clock import REAL_TIME, VirtualClock
    from .application import Application

    clock = VirtualClock(REAL_TIME)
    app = Application.create(clock, cfg, new_db=new_db)
    if new_db:
        # reference --newdb initializes and exits
        app.graceful_stop()
        clock.shutdown()
        print("database initialized")
        return 0
    app.start()

    def on_signal(_sig, _frame):
        clock.stop()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    try:
        while not clock.stopped:
            clock.crank(block=True, max_block=1.0)
    finally:
        for name in metrics:
            m = app.metrics.get(name)
            report = m.to_json() if m is not None else None
            print(json.dumps({name: report}))
        app.graceful_stop()
        clock.shutdown()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from .config import Config

    conf_path = "stellar-tpu.cfg"
    conf_explicit = False
    cmds = []
    metrics = []
    log_level = "info"
    new_db = False
    mode = "run"
    mode_arg = None
    newhist = []

    i = 0
    while i < len(argv):
        a = argv[i]

        def take():
            nonlocal i
            i += 1
            if i >= len(argv):
                print(f"{a} requires an argument", file=sys.stderr)
                raise SystemExit(2)
            return argv[i]

        if a in ("--help", "-h"):
            print(_usage())
            return 0
        elif a == "--conf":
            conf_path = take()
            conf_explicit = True
        elif a == "--c":
            cmds.append(take())
        elif a == "--ll":
            log_level = take()
        elif a == "--metric":
            metrics.append(take())
        elif a == "--newdb":
            new_db = True
        elif a == "--forcescp":
            mode = "forcescp"
        elif a == "--info":
            mode = "info"
        elif a == "--loadxdr":
            mode, mode_arg = "loadxdr", take()
        elif a == "--genseed":
            mode = "genseed"
        elif a == "--convertid":
            mode, mode_arg = "convertid", take()
        elif a == "--dumpxdr":
            mode, mode_arg = "dumpxdr", take()
        elif a == "--genfuzz":
            mode, mode_arg = "genfuzz", take()
        elif a == "--fuzz":
            mode, mode_arg = "fuzz", take()
        elif a == "--newhist":
            mode = "newhist"
            newhist.append(take())
        elif a == "--test":
            import pytest

            return pytest.main(argv[i + 1 :] or ["tests/"])
        else:
            print(f"unknown flag {a}\n{_usage()}", file=sys.stderr)
            return 2
        i += 1

    xlog.init(log_level)

    # modes that need no config
    if mode == "genseed":
        return _gen_seed()
    if mode == "convertid":
        return _print_id_representations(mode_arg)
    if mode == "dumpxdr":
        return _dump_xdr(mode_arg)
    if mode == "genfuzz":
        from .fuzz import gen_fuzz

        gen_fuzz(mode_arg)
        return 0
    if mode == "fuzz":
        from .fuzz import fuzz

        return fuzz(mode_arg)

    import os

    if os.path.exists(conf_path):
        cfg = Config.load(conf_path)
    elif conf_explicit:
        # a typo'd --conf must never silently boot a default-network node
        print(f"config file {conf_path!r} not found", file=sys.stderr)
        return 1
    else:
        print(f"no config file {conf_path!r}, using defaults", file=sys.stderr)
        cfg = Config()
        cfg.NETWORK_PASSPHRASE = "Standalone stellar-tpu network"

    if cfg.LOG_FILE_PATH:
        xlog.add_file(cfg.LOG_FILE_PATH)
    if mode == "forcescp":
        return _set_force_scp(cfg)
    if mode == "info":
        return _report_info(cfg)
    if mode == "loadxdr":
        return _load_xdr(cfg, mode_arg)
    if mode == "newhist":
        return _new_hist(cfg, newhist)
    if cmds:
        rc = 0
        for c in cmds:
            rc |= _send_command(cfg, c)
        return rc
    return _run_node(cfg, new_db, metrics)


if __name__ == "__main__":
    raise SystemExit(main())
