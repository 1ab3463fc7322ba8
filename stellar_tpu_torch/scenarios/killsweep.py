"""Kill-sweep harness — the storage half of the chaos story's proof.

``python -m stellar_tpu.scenarios --kill-sweep`` drives one standalone
validator through a deterministic close+publish window, then, for every
registered durable-write kill-point the window crosses (util/fs.py),
spawns a fresh subprocess that HARD-KILLS itself (``os._exit``) at
exactly that point — optionally leaving a truncated or torn file behind
— restarts the node on the survivor's on-disk state, and asserts the
boot self-check (main/selfcheck.py) repairs it back onto the control
run's exact trajectory: bit-identical LCL hash, bucket-list hash, and
full SQL state digest at the target ledger, with ``checkdb`` green and
the publish queue drained.

Determinism: the window's transactions and close times are pure
functions of the ledger sequence, so a node resumed from ANY kill point
re-closes the remaining ledgers to the same hashes iff its repaired
state is exactly the pre-kill durable state.  Two control legs run the
window through both bucket-merge engines (C and Python — bit-identical
output, pinned by tests/test_native_merge.py) so both engines' kill
points are enumerable and every kill child runs the leg that actually
crosses its point.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from ..util import fs
from .storagefaults import KILL_EXIT_CODE, KillPointTrace, install_from_env

# fixed epoch for close times: monotone in seq, identical across lives
CLOSE_T0 = 1_700_000_000
DEFAULT_TARGET = 10
CHECKPOINT_FREQ = 4

# kill-points where the torn/truncated-file modes are ALSO swept (the
# payload is complete-but-unsynced on disk there).  publish.stage-bucket
# is deliberately exit-only: the staging entry is a HARD LINK, so
# corrupting it would corrupt the canonical bucket through the shared
# inode — that shape (canonical-file corruption + archive re-fetch) is
# exercised deterministically by tests/test_selfcheck.py instead.
CORRUPTIBLE_STAGES = (":write",)


# -- the child node (one subprocess per sweep leg) ---------------------------


def _child_config(workdir: str, signature_backend: Optional[str] = None):
    from ..tx.testutils import get_test_config

    cfg = get_test_config(9500)
    if signature_backend is not None:
        cfg.SIGNATURE_BACKEND = signature_backend
    cfg.DATABASE = f"sqlite3://{workdir}/node.db"
    cfg.BUCKET_DIR_PATH = f"{workdir}/buckets"
    cfg.TMP_DIR_PATH = f"{workdir}/tmp"
    cfg.HTTP_PORT = 0
    cfg.CHECKPOINT_FREQUENCY = CHECKPOINT_FREQ
    # no FORCE_SCP: the window drives closes directly (deterministic
    # close times), the herder only persists/restores SCP state
    cfg.FORCE_SCP = False
    archive = f"{workdir}/archive"
    cfg.HISTORY = {
        "sweep": {
            "get": f"cp {archive}/{{0}} {{1}}",
            "put": f"cp {{0}} {archive}/{{1}}",
            "mkdir": f"mkdir -p {archive}/{{0}}",
        }
    }
    return cfg


def _window_txs(app, seq: int):
    """The deterministic load: a pure function of the ledger sequence
    (and therefore of the durable state a repaired node resumes from)."""
    from ..ledger.accountframe import AccountFrame
    from ..tx import testutils as T

    root = T.root_key_for(app)
    accounts = [T.get_account(f"sweep-{i}") for i in range(3)]
    root_seq = AccountFrame.load_account(
        root.get_public_key(), app.database
    ).get_seq_num()
    if seq == 2:
        ops = [T.create_account_op(a, 10**15) for a in accounts]
        return [T.tx_from_ops(app, root, root_seq + 1, ops)]
    dest = accounts[seq % len(accounts)]
    return [
        T.tx_from_ops(
            app, root, root_seq + 1,
            [T.payment_op(dest, 1000 + seq)],
        )
    ]


def _drain_publish(app, timeout: float = 120.0) -> bool:
    from ..history import publish as publish_queue

    hm = app.history_manager

    def drained():
        return (
            publish_queue.min_queued(app.database) == 0
            and not hm.publishing
        )

    app.clock.post(hm.publish_queued_history)
    return app.clock.crank_until(drained, timeout)


def _dump_result(app) -> dict:
    import hashlib

    from ..history import publish as publish_queue
    from ..tx.testutils import dump_state

    lm = app.ledger_manager
    state = dump_state(app.database)
    checkdb = "skipped"
    try:
        checkdb = app.bucket_manager.check_db()["status"]
    except Exception as e:
        checkdb = f"FAILED: {e}"
    return {
        "lcl_seq": lm.get_last_closed_ledger_num(),
        "lcl_hash": lm.last_closed.hash.hex(),
        "bucket_hash": app.bucket_manager.get_hash().hex(),
        "state_digest": hashlib.sha256(
            repr(state).encode()
        ).hexdigest(),
        "queued_checkpoints": len(
            publish_queue.queued_checkpoints(app.database)
        ),
        "checkdb": checkdb,
        "selfcheck": app.last_selfcheck,
    }


def child_main(
    workdir: str, target: int, out_path: str, signature_backend: Optional[str] = None
) -> int:
    """One sweep leg: boot (fresh or resumed), arm any env-specified
    fault, close to ``target`` with deterministic load, drain publish,
    dump the verdict JSON.  A kill child never reaches the dump — it
    ``os._exit``s at its point."""
    from ..main.application import Application
    from ..tx.testutils import close_ledger_on
    from ..util.clock import REAL_TIME, VirtualClock

    os.makedirs(workdir, exist_ok=True)
    os.makedirs(f"{workdir}/archive", exist_ok=True)
    fresh = not os.path.exists(f"{workdir}/node.db")
    cfg = _child_config(workdir, signature_backend)
    clock = VirtualClock(REAL_TIME)
    app = Application.create(clock, cfg, new_db=fresh)
    hooks = []
    try:
        app.start()
        # the fault window opens AFTER boot: control and kill children
        # count hits from the same instant, so (point, nth=1) means the
        # same moment in both
        hooks = install_from_env()
        lm = app.ledger_manager
        while lm.get_last_closed_ledger_num() < target:
            seq = lm.current.header.ledgerSeq
            close_ledger_on(
                app, CLOSE_T0 + seq * 5, txs=_window_txs(app, seq)
            )
            # the herder's own persist rides externalize; the sweep
            # window drives closes directly, so persist explicitly —
            # same kill-points, same row
            app.herder.persist_scp_state(seq)
        ok = _drain_publish(app)
        for h in hooks:
            fs.remove_kill_hook(h)
        hooks = []
        result = _dump_result(app)
        result["publish_drained"] = bool(ok)
        with open(out_path, "w") as f:
            json.dump(result, f, sort_keys=True)
        return 0
    finally:
        for h in hooks:
            fs.remove_kill_hook(h)
        app.graceful_stop()
        clock.shutdown()


# -- the parent sweep --------------------------------------------------------


def ensure_points_registered() -> None:
    """Import every module that owns a kill-point so the parent's
    registry is the complete inventory (registration happens at import
    time; the parent never exercises most of these paths itself)."""
    from ..bucket import bucket, manager  # noqa: F401
    from ..database import database  # noqa: F401
    from ..herder import herder  # noqa: F401
    from ..history import publish, publishsm  # noqa: F401
    from ..ledger import manager as ledger_manager  # noqa: F401


# sentinel returncode for a timed-out sweep leg: never a real exit code,
# so every caller's rc check classifies the leg as failed/missed instead
# of the TimeoutExpired aborting the whole sweep with no report
TIMEOUT_RC = -9999


def _run_child(
    workdir: str,
    target: int,
    out_path: str,
    env_extra: Dict[str, str],
    timeout: float = 180.0,
    signature_backend: Optional[str] = None,
):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env.update(env_extra)
    cmd = [
        sys.executable, "-m", "stellar_tpu_torch.scenarios",
        "--kill-child", "--workdir", workdir,
        "--target", str(target), "--out", out_path,
    ]
    if signature_backend is not None:
        cmd += ["--signature-backend", signature_backend]
    try:
        return subprocess.run(
            cmd,
            env=env,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        def _text(b):
            if isinstance(b, bytes):
                return b.decode("utf-8", "replace")
            return b or ""

        return subprocess.CompletedProcess(
            cmd,
            TIMEOUT_RC,
            stdout=_text(e.stdout),
            stderr=_text(e.stderr)
            + "\n[sweep] child timed out after %.0f s" % timeout,
        )


def _slug(point: str, mode: str) -> str:
    return "%s-%s" % (point.replace(":", "_").replace(".", "_"), mode)


class SweepVerdict:
    def __init__(self, point, mode, leg):
        self.point = point
        self.mode = mode
        self.leg = leg
        self.ok = False
        self.detail = ""
        self.selfcheck_status = None
        self.resumed_lcl = None

    def to_dict(self):
        return {
            "point": self.point,
            "mode": self.mode,
            "leg": self.leg,
            "ok": self.ok,
            "detail": self.detail,
            "selfcheck": self.selfcheck_status,
            "resumed_lcl": self.resumed_lcl,
        }


def run_kill_sweep(
    points: Optional[List[str]] = None,
    all_modes: bool = True,
    target: int = DEFAULT_TARGET,
    base_dir: Optional[str] = None,
    keep: bool = False,
    log=print,
    signature_backend: Optional[str] = None,
) -> dict:
    """The full sweep.  Returns a report dict; ``report["ok"]`` is the
    green/red verdict (any unrecovered point, hash mismatch, missed
    kill, or failed resume is red).  ``signature_backend`` is every
    child's Config.SIGNATURE_BACKEND (None keeps the test default)."""
    own_base = base_dir is None
    base = base_dir or tempfile.mkdtemp(prefix="stellar-tpu-killsweep-")
    os.makedirs(base, exist_ok=True)
    ensure_points_registered()
    legs = {
        "native": {},
        "pymerge": {"STELLAR_TPU_NO_NATIVE_MERGE": "1"},
    }
    try:
        # -- control legs: enumerate the window's kill points + pin the
        # target state both merge engines must agree on
        controls, hit_points = {}, {}
        for leg, env in legs.items():
            wd = os.path.join(base, f"control-{leg}")
            out = os.path.join(wd, "result.json")
            trace = os.path.join(base, f"trace-{leg}.tsv")
            os.makedirs(wd, exist_ok=True)
            proc = _run_child(
                wd, target, out,
                {**env, "STELLAR_TPU_KILLPOINT_TRACE": trace},
                signature_backend=signature_backend,
            )
            if proc.returncode != 0:
                return {
                    "ok": False,
                    "error": "control leg %r failed rc=%d: %s" % (
                        leg, proc.returncode, proc.stderr[-2000:]
                    ),
                    "verdicts": [],
                }
            with open(out) as f:
                controls[leg] = json.load(f)
            hit_points[leg] = KillPointTrace.read_points(trace)
        if (
            controls["native"]["lcl_hash"] != controls["pymerge"]["lcl_hash"]
            or controls["native"]["bucket_hash"]
            != controls["pymerge"]["bucket_hash"]
            or controls["native"]["state_digest"]
            != controls["pymerge"]["state_digest"]
        ):
            return {
                "ok": False,
                "error": "merge engines disagree on the control state",
                "verdicts": [],
            }
        control = controls["native"]

        # -- the plan: every hit point, on the leg that crosses it.
        # ``crossed`` is the window's coverage (every point the control
        # legs traversed — the acceptance's >= 25 inventory); ``swept``
        # is what this run actually kills, which a --points filter may
        # narrow.  Reporting them separately keeps a filtered run from
        # overstating its coverage.
        plan: List[tuple] = []
        swept, crossed = set(), set()
        for leg in ("native", "pymerge"):
            for p in hit_points[leg]:
                if p in crossed:
                    continue
                crossed.add(p)
                if points is not None and p not in points:
                    continue
                swept.add(p)
                plan.append((p, "exit", leg))
                if all_modes and p.endswith(CORRUPTIBLE_STAGES):
                    plan.append((p, "truncate", leg))
                    plan.append((p, "torn", leg))
        registered = sorted(fs.registered_kill_points())
        unexercised = [p for p in registered if p not in crossed]

        # -- kill + resume, one workdir per (point, mode)
        verdicts: List[SweepVerdict] = []
        for point, mode, leg in plan:
            v = SweepVerdict(point, mode, leg)
            verdicts.append(v)
            wd = os.path.join(base, _slug(point, mode))
            out = os.path.join(wd, "result.json")
            os.makedirs(wd, exist_ok=True)
            kill_env = {
                **legs[leg],
                "STELLAR_TPU_KILL_POINT": f"{point}:1:{mode}",
            }
            proc = _run_child(
                wd, target, out, kill_env, signature_backend=signature_backend
            )
            if proc.returncode != KILL_EXIT_CODE:
                if proc.returncode == TIMEOUT_RC:
                    v.detail = "kill child timed out before the point fired"
                else:
                    v.detail = (
                        "kill child survived (rc=%d) — point never fired"
                        % proc.returncode
                    )
                log("  %-42s %-8s MISSED  %s" % (point, mode, v.detail))
                continue
            proc = _run_child(
                wd, target, out, dict(legs[leg]),
                signature_backend=signature_backend,
            )
            if proc.returncode != 0:
                v.detail = "resume failed rc=%d: %s" % (
                    proc.returncode, (proc.stderr or "")[-800:]
                )
                log("  %-42s %-8s FAIL    %s" % (point, mode, v.detail))
                continue
            with open(out) as f:
                resumed = json.load(f)
            sc = resumed.get("selfcheck") or {}
            v.selfcheck_status = sc.get("status")
            v.resumed_lcl = resumed.get("lcl_seq")
            mismatches = [
                k
                for k in ("lcl_hash", "bucket_hash", "state_digest")
                if resumed.get(k) != control[k]
            ]
            if mismatches:
                v.detail = "state mismatch vs control: %s" % mismatches
            elif resumed.get("checkdb") != "ok":
                v.detail = "checkdb after repair: %s" % resumed.get("checkdb")
            elif resumed.get("queued_checkpoints"):
                v.detail = (
                    "%d checkpoint(s) still queued after resume"
                    % resumed["queued_checkpoints"]
                )
            elif v.selfcheck_status not in ("ok", "repaired"):
                v.detail = "selfcheck status %r" % v.selfcheck_status
            else:
                v.ok = True
            log(
                "  %-42s %-8s %s selfcheck=%s"
                % (
                    point, mode,
                    "ok  " if v.ok else "FAIL",
                    v.selfcheck_status,
                )
            )
            if not keep and v.ok:
                shutil.rmtree(wd, ignore_errors=True)

        n_ok = sum(1 for v in verdicts if v.ok)
        report = {
            "ok": bool(verdicts) and n_ok == len(verdicts),
            "target_ledger": target,
            "control": {
                k: control[k]
                for k in ("lcl_seq", "lcl_hash", "bucket_hash")
            },
            "points_hit": sorted(crossed),
            "points_swept": sorted(swept),
            "points_registered": len(registered),
            "points_unexercised": unexercised,
            "swept": len(verdicts),
            "recovered": n_ok,
            "verdicts": [v.to_dict() for v in verdicts],
        }
        return report
    finally:
        if own_base and not keep:
            shutil.rmtree(base, ignore_errors=True)
