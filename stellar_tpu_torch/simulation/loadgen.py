"""LoadGenerator — synthetic account/payment load at a target tx rate
(reference: src/simulation/LoadGenerator.{h,cpp}).

Step-driven on a VirtualTimer (STEP_MSECS cadence): first funds synthetic
accounts from the root, then streams payments between random accounts,
submitting through the node's own Herder (and flooding, if an overlay is
up) — exactly the reference's "tx?" path, so every generated tx takes the
full validity + signature pipeline.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..crypto.keys import SecretKey
from ..util import VirtualTimer, xlog

log = xlog.logger("LoadGen")

STEP_SECONDS = 0.1
MIN_ACCOUNT_BALANCE = 1_000_000_000  # fund enough for many fees


@dataclass
class TestAccount:
    """A synthetic account with local sequence tracking
    (LoadGenerator.h TestAccount/AccountInfo).  Every account can issue
    its own 4-char credit, like the reference's issuer/trustline graph."""

    key: SecretKey
    idx: int = 0
    seq: int = 0
    created: bool = False
    # issuer idx list (reference mTrustLines)
    trustlines: list = field(default_factory=list)
    offers: int = 0

    def asset(self):
        from ..xdr import entries as E

        code = b"L%03d" % (self.idx % 1000)
        return E.Asset.alphanum4(code, self.key.get_public_key())


class LoadGenerator:
    def __init__(self, seed: int = 1337):
        self.accounts: List[TestAccount] = []
        self._rng = random.Random(seed)
        self.timer: Optional[VirtualTimer] = None
        self.pending_accounts = 0
        self.pending_txs = 0
        self.rate = 10
        self.auto_rate = False
        self.mix = "payments"
        self.backlog_ledgers = 0
        self._last_second = -1
        self._root_seq = 0
        self._running = False

    # -- public api ---------------------------------------------------------
    def generate_load(
        self, app, n_accounts: int, n_txs: int, rate: int,
        auto_rate: bool = False, mix: str = "payments",
        backlog_ledgers: int = 0,
    ) -> None:
        """(CommandHandler 'generateload') queue work and start stepping.

        ``auto_rate`` enables the reference's auto-calibration
        (LoadGenerator.cpp:334-402, the [autoload] mode): once a second
        the target rate adjusts toward the point where the mean ledger
        close time sits at half the close cadence.

        ``mix='full'`` adds the reference's richer random-tx shapes
        (LoadGenerator.cpp:664-684 createRandomTransaction): trustline
        creation, credit payments along trustlines, and market-maker
        offers, alongside native payments.

        ``backlog_ledgers`` is the >1-close backlog shape (ROADMAP #3's
        remaining leg): each step tops the target herder's pending-tx
        queue up to ``backlog_ledgers × maxTxSetSize`` (rate permitting
        nothing — the backlog goal overrides the step budget), so every
        close proposes a full set with MORE work already queued behind it.
        Combined with a partition/heal or catchup replay, the externalized
        backlog then drains through ClosePipeline at dispatch-ahead depth
        ≥ 2 with non-empty prewarm candidates — the steady-state shape the
        pipeline was built for."""
        self.pending_accounts += n_accounts
        self.pending_txs += n_txs
        self.rate = max(1, rate)
        self.auto_rate = auto_rate
        self.mix = mix
        self.backlog_ledgers = backlog_ledgers
        if not self._running:
            self._running = True
            if self.timer is None:
                self.timer = VirtualTimer(app.clock)
            self._schedule(app)

    def stop(self) -> None:
        """Abandon remaining work and cancel the step timer (scenario
        teardown: a dead app's clock must not fire loadgen steps)."""
        self.pending_accounts = 0
        self.pending_txs = 0
        self._running = False
        if self.timer is not None:
            self.timer.cancel()

    # -- auto-rate calibration (LoadGenerator.cpp:172-199, 334-402) ---------
    def _maybe_adjust_rate(self, target: float, actual: float,
                           increase_ok: bool) -> bool:
        if actual == 0.0:
            actual = 1.0
        diff = target - actual
        if abs(diff) <= 0.1 * target:
            return False
        pct = min(1.0, diff / actual)  # cap at doubling per adjustment
        incr = int(pct * self.rate)
        if incr > 0 and not increase_ok:
            return False
        log.info("auto-tx rate %d -> %d", self.rate, self.rate + incr)
        self.rate = max(1, self.rate + incr)
        return True

    def _auto_adjust(self, app) -> None:
        now = int(app.clock.now())
        if now == self._last_second:
            return
        self._last_second = now
        close_timer = app.metrics.new_timer(("ledger", "ledger", "close"))
        if app.ledger_manager.get_ledger_num() <= 10 or close_timer.count <= 5:
            return
        target_age = 1000.0 if (
            app.config.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING
        ) else 5000.0
        # "well loaded" = mean close time near half the ledger cadence
        self._maybe_adjust_rate(
            target_age / 2.0, close_timer.histogram.mean, increase_ok=True
        )
        if self.rate > 5000:
            log.warning("auto rate > 5000, likely metric stutter; resetting")
            self.rate = 10
        close_timer.histogram.clear()

    def is_done(self) -> bool:
        return self.pending_accounts == 0 and self.pending_txs == 0

    @staticmethod
    def invariants_clean(app) -> bool:
        """Ledger-invariant oracle for load runs (stellar_tpu/invariant/):
        True iff the node's invariant plane saw zero violations on the
        ledgers this load drove.  Tests assert this after cranking a load
        to completion; _step logs it when generation finishes."""
        inv = getattr(app, "invariants", None)
        return inv is None or inv.total_violations == 0

    # -- stepping -----------------------------------------------------------
    def _schedule(self, app) -> None:
        self.timer.expires_from_now(STEP_SECONDS)
        self.timer.async_wait(lambda: self._step(app))

    def _step(self, app) -> None:
        if self.is_done():
            self._running = False
            if not self.invariants_clean(app):
                log.error(
                    "loadgen: %d ledger-invariant violation(s) fired on "
                    "ledgers this load drove — close-path bug exposed",
                    app.invariants.total_violations,
                )
            log.info("load generation complete (%d accounts live)", len(self.accounts))
            return
        if self.auto_rate:
            self._auto_adjust(app)
        budget = max(1, int(self.rate * STEP_SECONDS))
        if self.backlog_ledgers > 0:
            # >1-close backlog shape: keep backlog_ledgers ledgers' worth
            # of transactions pending in the herder at all times
            want = (
                self.backlog_ledgers
                * app.ledger_manager.get_max_tx_set_size()
            )
            budget = max(budget, want - self._herder_pending(app))
        submitted = 0
        # only count work off the pending totals when the herder accepted
        # it; a rejection (queue full, fee check) is retried next step
        while submitted < budget and self.pending_accounts > 0:
            if not self._submit_create_account(app):
                break
            submitted += 1
            self.pending_accounts -= 1
        while submitted < budget and self.pending_txs > 0 and self._have_live_accounts():
            if not self._submit_random_tx(app):
                break
            submitted += 1
            self.pending_txs -= 1
        self._schedule(app)

    def _have_live_accounts(self) -> bool:
        return sum(1 for a in self.accounts if a.created) >= 2

    @staticmethod
    def _herder_pending(app) -> int:
        herder = app.herder
        if hasattr(herder, "num_pending_txs"):
            return herder.num_pending_txs()
        return sum(
            len(txmap.transactions)
            for gen in app.herder.received_transactions
            for txmap in gen.values()
        )

    # -- tx builders --------------------------------------------------------
    def _root(self, app):
        from ..tx import testutils as T
        from ..ledger.accountframe import AccountFrame

        key = T.root_key_for(app)
        if self._root_seq == 0:
            frame = AccountFrame.load_account(key.get_public_key(), app.database)
            self._root_seq = frame.get_seq_num()
        return key

    def _submit(self, app, tx) -> bool:
        from ..herder.herder import TX_STATUS_PENDING

        # ride the admission front door when the node has one: loadgen
        # traffic shares the micro-batch (and the rate/surge gates) with
        # the overlay flood, exactly like a real submitter would
        ingest = getattr(app, "ingest", None)
        if ingest is not None:
            status = ingest.submit_sync(tx)
        else:
            status = app.herder.recv_transaction(tx)
        if status != TX_STATUS_PENDING:
            log.debug("loadgen tx rejected: %s", status)
            return False
        if app.overlay_manager is not None:
            app.overlay_manager.broadcast_message(tx.to_stellar_message())
        return True

    def _submit_create_account(self, app) -> bool:
        from ..tx import testutils as T

        root = self._root(app)
        acct = TestAccount(
            SecretKey.pseudo_random_for_testing(5000 + len(self.accounts)),
            idx=len(self.accounts),
        )
        self._root_seq += 1
        tx = T.tx_from_ops(
            app,
            root,
            self._root_seq,
            [T.create_account_op(acct.key, MIN_ACCOUNT_BALANCE)],
        )
        if not self._submit(app, tx):
            self._root_seq -= 1
            return False
        acct.created = True  # optimistic; consensus applies it
        self.accounts.append(acct)
        return True

    def _submit_random_tx(self, app) -> bool:
        """Pick a tx shape per the configured mix; anything whose
        preconditions don't hold falls back to a native payment
        (reference createRandomTransaction)."""
        if self.mix == "full":
            r = self._rng.random()
            if r < 0.15 and self._submit_trust(app):
                return True
            if r < 0.30 and self._submit_credit_payment(app):
                return True
            if r < 0.40 and self._submit_offer(app):
                return True
        return self._submit_payment(app)

    def _load_seq(self, app, acct) -> bool:
        from ..ledger.accountframe import AccountFrame

        if acct.seq == 0:
            frame = AccountFrame.load_account(
                acct.key.get_public_key(), app.database
            )
            if frame is None:
                return False
            acct.seq = frame.get_seq_num()
        return True

    def _submit_trust(self, app) -> bool:
        """A random live account opens a trustline to another live
        account's credit (reference createEstablishTrustTransaction)."""
        from ..tx import testutils as T

        live = [a for a in self.accounts if a.created]
        if len(live) < 2:
            return False
        truster, issuer = self._rng.sample(live, 2)
        if issuer.idx in truster.trustlines or not self._load_seq(app, truster):
            return False
        truster.seq += 1
        tx = T.tx_from_ops(
            app,
            truster.key,
            truster.seq,
            [T.change_trust_op(issuer.asset(), 10**15)],
        )
        if not self._submit(app, tx):
            truster.seq -= 1
            return False
        truster.trustlines.append(issuer.idx)
        return True

    def _trust_pairs(self):
        # idx is the account's position in self.accounts by construction
        return [
            (a, self.accounts[i])
            for a in self.accounts
            if a.created and a.trustlines
            for i in a.trustlines
            if i < len(self.accounts) and self.accounts[i].created
        ]

    def _submit_credit_payment(self, app) -> bool:
        """An issuer pays its own credit to an account trusting it
        (reference createTransferCreditTransaction)."""
        from ..tx import testutils as T

        pairs = self._trust_pairs()
        if not pairs:
            return False
        truster, issuer = self._rng.choice(pairs)
        if not self._load_seq(app, issuer):
            return False
        issuer.seq += 1
        amount = self._rng.randint(10, 10_000)
        tx = T.tx_from_ops(
            app,
            issuer.key,
            issuer.seq,
            [T.payment_op(truster.key, amount, asset=issuer.asset())],
        )
        if not self._submit(app, tx):
            issuer.seq -= 1
            return False
        return True

    def _submit_offer(self, app) -> bool:
        """An account holding a trustline market-makes: sells native for
        the credit it trusts (reference createMarketMakingTransaction)."""
        from ..tx import testutils as T
        from ..xdr import entries as E

        pairs = self._trust_pairs()
        if not pairs:
            return False
        truster, issuer = self._rng.choice(pairs)
        if not self._load_seq(app, truster):
            return False
        truster.seq += 1
        tx = T.tx_from_ops(
            app,
            truster.key,
            truster.seq,
            [
                T.manage_offer_op(
                    E.Asset.native(),
                    issuer.asset(),
                    self._rng.randint(10, 1000),
                    E.Price(1, 1),
                )
            ],
        )
        if not self._submit(app, tx):
            truster.seq -= 1
            return False
        truster.offers += 1
        return True

    def _submit_payment(self, app) -> bool:
        from ..tx import testutils as T

        live = [a for a in self.accounts if a.created]
        src, dst = self._rng.sample(live, 2)
        if not self._load_seq(app, src):
            return False  # not applied yet; retry never — skip
        src.seq += 1
        amount = self._rng.randint(10, 10_000)
        tx = T.tx_from_ops(
            app, src.key, src.seq, [T.payment_op(dst.key, amount)]
        )
        if not self._submit(app, tx):
            src.seq -= 1
            return False
        return True
