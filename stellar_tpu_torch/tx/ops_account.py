"""Account-administration operations (reference:
CreateAccountOpFrame.cpp, SetOptionsOpFrame.cpp, ChangeTrustOpFrame.cpp,
AllowTrustOpFrame.cpp, MergeOpFrame.cpp, InflationOpFrame.cpp)."""

from __future__ import annotations

from ..ledger.accountframe import AccountFrame
from ..ledger.delta import LedgerDelta
from ..ledger.trustframe import TrustFrame
from ..util.xmath import big_divide
from ..xdr.entries import (
    Asset,
    AssetType,
    LedgerEntry,
    LedgerEntryData,
    LedgerEntryType,
    MASK_ACCOUNT_FLAGS,
    ThresholdIndexes,
    TrustLineEntry,
)
from ..xdr.txs import (
    AccountMergeResult,
    AccountMergeResultCode,
    AllowTrustResult,
    AllowTrustResultCode,
    ChangeTrustResult,
    ChangeTrustResultCode,
    CreateAccountResult,
    CreateAccountResultCode,
    InflationPayout,
    InflationResult,
    InflationResultCode,
    SetOptionsResult,
    SetOptionsResultCode,
)
from .opframe import OperationFrame, is_asset_valid, is_string32_valid

# AUTH_REQUIRED | AUTH_REVOCABLE | AUTH_IMMUTABLE — once immutable is set,
# NO auth flag (immutable included) may change (SetOptionsOpFrame.cpp:15-18)
ALL_ACCOUNT_AUTH_FLAGS = 0x7
MAX_SIGNERS = 20

# inflation constants (InflationOpFrame.cpp:12-19)
INFLATION_FREQUENCY = 60 * 60 * 24 * 7  # every 7 days
INFLATION_RATE_TRILLIONTHS = 190721000
TRILLION = 1000000000000
INFLATION_WIN_MIN_PERCENT = 500000000  # .05%
INFLATION_NUM_WINNERS = 2000
INFLATION_START_TIME = 1404172800  # 1-jul-2014


class CreateAccountOpFrame(OperationFrame):
    @property
    def ca(self):
        return self.operation.body.value

    def do_check_valid(self, metrics) -> bool:
        if self.ca.startingBalance <= 0:
            metrics.new_meter(
                ("op-create-account", "invalid", "malformed-negative-balance"),
                "operation",
            ).mark()
            self.set_inner_result(
                CreateAccountResult(CreateAccountResultCode.CREATE_ACCOUNT_MALFORMED)
            )
            return False
        if self.ca.destination == self.get_source_id():
            metrics.new_meter(
                ("op-create-account", "invalid", "malformed-destination-equals-source"),
                "operation",
            ).mark()
            self.set_inner_result(
                CreateAccountResult(CreateAccountResultCode.CREATE_ACCOUNT_MALFORMED)
            )
            return False
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        db = lm.database
        dest = AccountFrame.load_account(self.ca.destination, db)
        if dest is not None:
            metrics.new_meter(
                ("op-create-account", "failure", "already-exist"), "operation"
            ).mark()
            self.set_inner_result(
                CreateAccountResult(CreateAccountResultCode.CREATE_ACCOUNT_ALREADY_EXIST)
            )
            return False
        if self.ca.startingBalance < lm.get_min_balance(0):
            metrics.new_meter(
                ("op-create-account", "failure", "low-reserve"), "operation"
            ).mark()
            self.set_inner_result(
                CreateAccountResult(CreateAccountResultCode.CREATE_ACCOUNT_LOW_RESERVE)
            )
            return False
        min_balance = self.source_account.get_minimum_balance(lm)
        if self.source_account.get_balance() - min_balance < self.ca.startingBalance:
            metrics.new_meter(
                ("op-create-account", "failure", "underfunded"), "operation"
            ).mark()
            self.set_inner_result(
                CreateAccountResult(CreateAccountResultCode.CREATE_ACCOUNT_UNDERFUNDED)
            )
            return False
        self.source_account.mut().balance -= self.ca.startingBalance
        self.source_account.store_change(delta, db)
        dest = AccountFrame(account_id=self.ca.destination)
        # new accounts start at (currentLedgerSeq << 32)
        body = dest.mut()
        body.seqNum = delta.header_ro().ledgerSeq << 32
        body.balance = self.ca.startingBalance
        dest.store_add(delta, db)
        metrics.new_meter(("op-create-account", "success", "apply"), "operation").mark()
        self.set_inner_result(
            CreateAccountResult(CreateAccountResultCode.CREATE_ACCOUNT_SUCCESS)
        )
        return True


class SetOptionsOpFrame(OperationFrame):
    @property
    def so(self):
        return self.operation.body.value

    def get_needed_threshold(self) -> int:
        so = self.so
        if (
            so.masterWeight is not None
            or so.lowThreshold is not None
            or so.medThreshold is not None
            or so.highThreshold is not None
            or so.signer is not None
        ):
            return self.source_account.get_high_threshold()
        return self.source_account.get_medium_threshold()

    def _fail(self, metrics, tag, code):
        if tag:
            metrics.new_meter(("op-set-options", "invalid", tag), "operation").mark()
        self.set_inner_result(SetOptionsResult(code))
        return False

    def do_check_valid(self, metrics) -> bool:
        so = self.so
        if so.setFlags is not None and so.setFlags & ~MASK_ACCOUNT_FLAGS:
            return self._fail(metrics, None, SetOptionsResultCode.SET_OPTIONS_UNKNOWN_FLAG)
        if so.clearFlags is not None and so.clearFlags & ~MASK_ACCOUNT_FLAGS:
            return self._fail(metrics, None, SetOptionsResultCode.SET_OPTIONS_UNKNOWN_FLAG)
        if (
            so.setFlags is not None
            and so.clearFlags is not None
            and so.setFlags & so.clearFlags
        ):
            return self._fail(
                metrics, "bad-flags", SetOptionsResultCode.SET_OPTIONS_BAD_FLAGS
            )
        for field in (so.masterWeight, so.lowThreshold, so.medThreshold, so.highThreshold):
            if field is not None and field > 255:
                return self._fail(
                    metrics,
                    "threshold-out-of-range",
                    SetOptionsResultCode.SET_OPTIONS_THRESHOLD_OUT_OF_RANGE,
                )
        if so.signer is not None and so.signer.pubKey == self.get_source_id():
            return self._fail(
                metrics, "bad-signer", SetOptionsResultCode.SET_OPTIONS_BAD_SIGNER
            )
        if so.homeDomain is not None and not is_string32_valid(so.homeDomain):
            return self._fail(
                metrics,
                "invalid-home-domain",
                SetOptionsResultCode.SET_OPTIONS_INVALID_HOME_DOMAIN,
            )
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        so = self.so
        db = lm.database
        # mut(): the shared signing frame may be sealed (fee charging or
        # an earlier op stored it); every branch below mutates `account`
        # in place, so bind the CoW-unsealed entry once up front
        account = self.source_account.mut()

        def fail(tag, code):
            metrics.new_meter(("op-set-options", "failure", tag), "operation").mark()
            self.set_inner_result(SetOptionsResult(code))
            return False

        if so.inflationDest is not None:
            if AccountFrame.load_account(so.inflationDest, db, readonly=True) is None:
                return fail(
                    "invalid-inflation",
                    SetOptionsResultCode.SET_OPTIONS_INVALID_INFLATION,
                )
            account.inflationDest = so.inflationDest

        for flags_change, is_set in ((so.clearFlags, False), (so.setFlags, True)):
            if flags_change is None:
                continue
            if (
                flags_change & ALL_ACCOUNT_AUTH_FLAGS
            ) and self.source_account.is_immutable_auth():
                return fail("cant-change", SetOptionsResultCode.SET_OPTIONS_CANT_CHANGE)
            if is_set:
                account.flags |= flags_change
            else:
                account.flags &= ~flags_change

        if so.homeDomain is not None:
            account.homeDomain = so.homeDomain

        th = bytearray(account.thresholds)
        for idx, v in (
            (ThresholdIndexes.THRESHOLD_MASTER_WEIGHT, so.masterWeight),
            (ThresholdIndexes.THRESHOLD_LOW, so.lowThreshold),
            (ThresholdIndexes.THRESHOLD_MED, so.medThreshold),
            (ThresholdIndexes.THRESHOLD_HIGH, so.highThreshold),
        ):
            if v is not None:
                th[idx] = v & 0xFF
        account.thresholds = bytes(th)

        if so.signer is not None:
            signers = account.signers
            if so.signer.weight:
                for old in signers:
                    if old.pubKey == so.signer.pubKey:
                        old.weight = so.signer.weight
                        break
                else:
                    if len(signers) >= MAX_SIGNERS:
                        return fail(
                            "too-many-signers",
                            SetOptionsResultCode.SET_OPTIONS_TOO_MANY_SIGNERS,
                        )
                    if not self.source_account.add_num_entries(1, lm):
                        return fail(
                            "low-reserve", SetOptionsResultCode.SET_OPTIONS_LOW_RESERVE
                        )
                    signers.append(so.signer)
            else:
                kept = []
                for old in signers:
                    if old.pubKey == so.signer.pubKey:
                        self.source_account.add_num_entries(-1, lm)
                    else:
                        kept.append(old)
                account.signers = kept
            # canonical raw-pubKey ordering is enforced by
            # AccountFrame._normalize at the store below

        metrics.new_meter(("op-set-options", "success", "apply"), "operation").mark()
        self.set_inner_result(SetOptionsResult(SetOptionsResultCode.SET_OPTIONS_SUCCESS))
        self.source_account.store_change(delta, db)
        return True


class ChangeTrustOpFrame(OperationFrame):
    @property
    def ct(self):
        return self.operation.body.value

    def do_check_valid(self, metrics) -> bool:
        if self.ct.limit < 0:
            metrics.new_meter(
                ("op-change-trust", "invalid", "malformed-negative-limit"), "operation"
            ).mark()
            self.set_inner_result(
                ChangeTrustResult(ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)
            )
            return False
        if not is_asset_valid(self.ct.line):
            metrics.new_meter(
                ("op-change-trust", "invalid", "malformed-invalid-asset"), "operation"
            ).mark()
            self.set_inner_result(
                ChangeTrustResult(ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)
            )
            return False
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        db = lm.database
        ct = self.ct

        def fail(tag, code):
            metrics.new_meter(("op-change-trust", "failure", tag), "operation").mark()
            self.set_inner_result(ChangeTrustResult(code))
            return False

        def succeed():
            metrics.new_meter(("op-change-trust", "success", "apply"), "operation").mark()
            self.set_inner_result(
                ChangeTrustResult(ChangeTrustResultCode.CHANGE_TRUST_SUCCESS)
            )
            return True

        if ct.line.is_native():
            return fail("malformed", ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)

        line, issuer = TrustFrame.load_trust_line_issuer(self.get_source_id(), ct.line, db)
        if line is not None:
            if ct.limit < line.get_balance():
                return fail("invalid-limit", ChangeTrustResultCode.CHANGE_TRUST_INVALID_LIMIT)
            if ct.limit == 0:
                line.store_delete(delta, db)
                self.source_account.add_num_entries(-1, lm)
                self.source_account.store_change(delta, db)
            else:
                if issuer is None:
                    return fail("no-issuer", ChangeTrustResultCode.CHANGE_TRUST_NO_ISSUER)
                line.mut().limit = ct.limit
                line.store_change(delta, db)
            return succeed()
        else:
            if ct.limit == 0:
                return fail("invalid-limit", ChangeTrustResultCode.CHANGE_TRUST_INVALID_LIMIT)
            if issuer is None:
                return fail("no-issuer", ChangeTrustResultCode.CHANGE_TRUST_NO_ISSUER)
            tl = TrustLineEntry(
                accountID=self.get_source_id(),
                asset=ct.line,
                balance=0,
                limit=ct.limit,
                flags=0,
                ext=0,
            )
            new_line = TrustFrame(
                LedgerEntry(0, LedgerEntryData(LedgerEntryType.TRUSTLINE, tl), 0)
            )
            new_line.set_authorized(not issuer.is_auth_required())
            if not self.source_account.add_num_entries(1, lm):
                return fail("low-reserve", ChangeTrustResultCode.CHANGE_TRUST_LOW_RESERVE)
            self.source_account.store_change(delta, db)
            new_line.store_add(delta, db)
            return succeed()


class AllowTrustOpFrame(OperationFrame):
    @property
    def at(self):
        return self.operation.body.value

    def get_needed_threshold(self) -> int:
        return self.source_account.get_low_threshold()

    def _asset(self) -> Asset:
        at = self.at
        if at.asset.type == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            return Asset.alphanum4(at.asset.value, self.get_source_id())
        return Asset.alphanum12(at.asset.value, self.get_source_id())

    def do_check_valid(self, metrics) -> bool:
        if self.at.asset.type == AssetType.ASSET_TYPE_NATIVE:
            metrics.new_meter(
                ("op-allow-trust", "invalid", "malformed-non-alphanum"), "operation"
            ).mark()
            self.set_inner_result(
                AllowTrustResult(AllowTrustResultCode.ALLOW_TRUST_MALFORMED)
            )
            return False
        if not is_asset_valid(self._asset()):
            metrics.new_meter(
                ("op-allow-trust", "invalid", "malformed-invalid-asset"), "operation"
            ).mark()
            self.set_inner_result(
                AllowTrustResult(AllowTrustResultCode.ALLOW_TRUST_MALFORMED)
            )
            return False
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        def fail(tag, code):
            metrics.new_meter(("op-allow-trust", "failure", tag), "operation").mark()
            self.set_inner_result(AllowTrustResult(code))
            return False

        if not self.source_account.is_auth_required():
            return fail("not-required", AllowTrustResultCode.ALLOW_TRUST_TRUST_NOT_REQUIRED)
        if not self.source_account.is_auth_revocable() and not self.at.authorize:
            return fail("cant-revoke", AllowTrustResultCode.ALLOW_TRUST_CANT_REVOKE)

        db = lm.database
        line = TrustFrame.load_trust_line(self.at.trustor, self._asset(), db)
        if line is None or line.is_issuer:
            return fail("no-trust-line", AllowTrustResultCode.ALLOW_TRUST_NO_TRUST_LINE)
        metrics.new_meter(("op-allow-trust", "success", "apply"), "operation").mark()
        self.set_inner_result(AllowTrustResult(AllowTrustResultCode.ALLOW_TRUST_SUCCESS))
        line.set_authorized(self.at.authorize)
        line.store_change(delta, db)
        return True


class MergeOpFrame(OperationFrame):
    def get_needed_threshold(self) -> int:
        return self.source_account.get_high_threshold()

    def do_check_valid(self, metrics) -> bool:
        if self.get_source_id() == self.operation.body.value:
            metrics.new_meter(
                ("op-merge", "invalid", "malformed-self-merge"), "operation"
            ).mark()
            self.set_inner_result(
                AccountMergeResult(AccountMergeResultCode.ACCOUNT_MERGE_MALFORMED)
            )
            return False
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        db = lm.database

        def fail(tag, code):
            metrics.new_meter(("op-merge", "failure", tag), "operation").mark()
            self.set_inner_result(AccountMergeResult(code))
            return False

        other = AccountFrame.load_account(self.operation.body.value, db)
        if other is None:
            return fail("no-account", AccountMergeResultCode.ACCOUNT_MERGE_NO_ACCOUNT)
        if self.source_account.is_immutable_auth():
            return fail("static-auth", AccountMergeResultCode.ACCOUNT_MERGE_IMMUTABLE_SET)
        acc = self.source_account.account
        # numSubEntries counts signers + trustlines + offers; equality with
        # len(signers) means no trustlines/offers remain
        if acc.numSubEntries != len(acc.signers):
            return fail(
                "has-sub-entries", AccountMergeResultCode.ACCOUNT_MERGE_HAS_SUB_ENTRIES
            )
        balance = acc.balance
        other.mut().balance += balance
        other.store_change(delta, db)
        self.source_account.store_delete(delta, db)
        metrics.new_meter(("op-merge", "success", "apply"), "operation").mark()
        self.set_inner_result(
            AccountMergeResult(AccountMergeResultCode.ACCOUNT_MERGE_SUCCESS, balance)
        )
        return True


class InflationOpFrame(OperationFrame):
    def get_needed_threshold(self) -> int:
        return self.source_account.get_low_threshold()

    def do_check_valid(self, metrics) -> bool:
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        inflation_delta = LedgerDelta(outer=delta)
        header = inflation_delta.get_header()
        close_time = header.scpValue.closeTime
        seq = header.inflationSeq
        inflation_time = INFLATION_START_TIME + seq * INFLATION_FREQUENCY
        if close_time < inflation_time:
            metrics.new_meter(("op-inflation", "failure", "not-time"), "operation").mark()
            self.set_inner_result(
                InflationResult(InflationResultCode.INFLATION_NOT_TIME)
            )
            return False

        total_votes = header.totalCoins
        min_votes = big_divide(total_votes, INFLATION_WIN_MIN_PERCENT, TRILLION)
        db = lm.database
        winners = [
            (votes, dest)
            for votes, dest in AccountFrame.process_for_inflation(
                db, INFLATION_NUM_WINNERS
            )
            if votes >= min_votes
        ]
        amount_to_dole = big_divide(
            header.totalCoins, INFLATION_RATE_TRILLIONTHS, TRILLION
        )
        amount_to_dole += header.feePool
        header.feePool = 0
        header.inflationSeq += 1

        payouts = []
        left = amount_to_dole
        for votes, dest in winners:
            to_dole = big_divide(amount_to_dole, votes, total_votes)
            if to_dole == 0:
                continue
            winner = AccountFrame.load_account(dest, db)
            if winner is not None:
                left -= to_dole
                header.totalCoins += to_dole
                winner.mut().balance += to_dole
                winner.store_change(inflation_delta, db)
                payouts.append(InflationPayout(dest, to_dole))
        header.feePool += left

        self.set_inner_result(
            InflationResult(InflationResultCode.INFLATION_SUCCESS, payouts)
        )
        inflation_delta.commit()
        metrics.new_meter(("op-inflation", "success", "apply"), "operation").mark()
        return True
