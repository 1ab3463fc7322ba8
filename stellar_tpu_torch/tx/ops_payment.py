"""Payment and PathPayment operations (reference:
src/transactions/PaymentOpFrame.cpp, PathPaymentOpFrame.cpp).

Payment is sugar over PathPayment with a single-asset path (the reference
literally builds a PathPaymentOp and maps its result codes back).
"""

from __future__ import annotations

from ..ledger.accountframe import AccountFrame
from ..ledger.trustframe import TrustFrame
from ..util.xmath import INT64_MAX
from ..xdr.txs import (
    Operation,
    OperationBody,
    OperationResult,
    OperationResultCode,
    OperationResultTr,
    OperationType,
    PathPaymentOp,
    PathPaymentResult,
    PathPaymentResultCode,
    PathPaymentSuccess,
    PaymentResult,
    PaymentResultCode,
    SimplePaymentResult,
)
from .offerexchange import ConvertResult, OfferExchange, OfferFilterResult
from .opframe import OperationFrame, is_asset_valid

_PP_TO_PAYMENT = {
    PathPaymentResultCode.PATH_PAYMENT_UNDERFUNDED: PaymentResultCode.PAYMENT_UNDERFUNDED,
    PathPaymentResultCode.PATH_PAYMENT_SRC_NOT_AUTHORIZED: PaymentResultCode.PAYMENT_SRC_NOT_AUTHORIZED,
    PathPaymentResultCode.PATH_PAYMENT_SRC_NO_TRUST: PaymentResultCode.PAYMENT_SRC_NO_TRUST,
    PathPaymentResultCode.PATH_PAYMENT_NO_DESTINATION: PaymentResultCode.PAYMENT_NO_DESTINATION,
    PathPaymentResultCode.PATH_PAYMENT_NO_TRUST: PaymentResultCode.PAYMENT_NO_TRUST,
    PathPaymentResultCode.PATH_PAYMENT_NOT_AUTHORIZED: PaymentResultCode.PAYMENT_NOT_AUTHORIZED,
    PathPaymentResultCode.PATH_PAYMENT_LINE_FULL: PaymentResultCode.PAYMENT_LINE_FULL,
    PathPaymentResultCode.PATH_PAYMENT_NO_ISSUER: PaymentResultCode.PAYMENT_NO_ISSUER,
}


class PaymentOpFrame(OperationFrame):
    @property
    def payment(self):
        return self.operation.body.value

    def do_check_valid(self, metrics) -> bool:
        if self.payment.amount <= 0:
            metrics.new_meter(
                ("op-payment", "invalid", "malformed-negative-amount"), "operation"
            ).mark()
            self.set_inner_result(PaymentResult(PaymentResultCode.PAYMENT_MALFORMED))
            return False
        if not is_asset_valid(self.payment.asset):
            metrics.new_meter(
                ("op-payment", "invalid", "malformed-invalid-asset"), "operation"
            ).mark()
            self.set_inner_result(PaymentResult(PaymentResultCode.PAYMENT_MALFORMED))
            return False
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        if self.payment.destination == self.get_source_id():
            metrics.new_meter(("op-payment", "success", "apply"), "operation").mark()
            self.set_inner_result(PaymentResult(PaymentResultCode.PAYMENT_SUCCESS))
            return True

        pp_op = Operation(
            self.operation.sourceAccount,
            OperationBody(
                OperationType.PATH_PAYMENT,
                PathPaymentOp(
                    sendAsset=self.payment.asset,
                    sendMax=self.payment.amount,
                    destination=self.payment.destination,
                    destAsset=self.payment.asset,
                    destAmount=self.payment.amount,
                    path=[],
                ),
            ),
        )
        pp_res = OperationResult(
            OperationResultCode.opINNER,
            OperationResultTr(OperationType.PATH_PAYMENT, None),
        )
        pp = PathPaymentOpFrame(pp_op, pp_res, self.parent_tx)
        pp.source_account = self.source_account

        if not pp.do_check_valid(metrics) or not pp.do_apply(metrics, delta, lm):
            if pp.get_result_code() != OperationResultCode.opINNER:
                raise RuntimeError("Unexpected error code from pathPayment")
            inner_code = pp.inner_result().type
            mapped = _PP_TO_PAYMENT.get(inner_code)
            if mapped is None:
                raise RuntimeError("Unexpected error code from pathPayment")
            self.set_inner_result(PaymentResult(mapped))
            return False

        assert pp.inner_result().type == PathPaymentResultCode.PATH_PAYMENT_SUCCESS
        metrics.new_meter(("op-payment", "success", "apply"), "operation").mark()
        self.set_inner_result(PaymentResult(PaymentResultCode.PAYMENT_SUCCESS))
        return True


class PathPaymentOpFrame(OperationFrame):
    @property
    def pp(self):
        return self.operation.body.value

    def _fail(self, metrics, tag, code, no_issuer_asset=None):
        metrics.new_meter(("op-path-payment", "failure", tag), "operation").mark()
        if code == PathPaymentResultCode.PATH_PAYMENT_NO_ISSUER:
            self.set_inner_result(PathPaymentResult(code, no_issuer_asset))
        else:
            self.set_inner_result(PathPaymentResult(code))
        return False

    def do_check_valid(self, metrics) -> bool:
        pp = self.pp
        if pp.destAmount <= 0 or pp.sendMax <= 0:
            metrics.new_meter(
                ("op-path-payment", "invalid", "malformed-amounts"), "operation"
            ).mark()
            self.set_inner_result(
                PathPaymentResult(PathPaymentResultCode.PATH_PAYMENT_MALFORMED)
            )
            return False
        if not is_asset_valid(pp.sendAsset) or not is_asset_valid(pp.destAsset) or not all(
            is_asset_valid(a) for a in pp.path
        ):
            metrics.new_meter(
                ("op-path-payment", "invalid", "malformed-currencies"), "operation"
            ).mark()
            self.set_inner_result(
                PathPaymentResult(PathPaymentResultCode.PATH_PAYMENT_MALFORMED)
            )
            return False
        return True

    def do_apply(self, metrics, delta, lm) -> bool:
        db = lm.database
        pp = self.pp

        success = PathPaymentSuccess([], None)
        self.set_inner_result(
            PathPaymentResult(PathPaymentResultCode.PATH_PAYMENT_SUCCESS, success)
        )

        cur_b_received = pp.destAmount
        cur_b = pp.destAsset
        full_path = [pp.sendAsset] + list(pp.path)

        # send-credits-back-to-issuer shortcut: destination account need not
        # exist when it IS the issuer of a direct single-asset payment
        bypass_issuer_check = (
            not cur_b.is_native()
            and len(full_path) == 1
            and pp.sendAsset == pp.destAsset
            and cur_b.code_and_issuer()[1] == pp.destination
        )

        destination = None
        if not bypass_issuer_check:
            destination = AccountFrame.load_account(pp.destination, db)
            if destination is None:
                return self._fail(
                    metrics,
                    "no-destination",
                    PathPaymentResultCode.PATH_PAYMENT_NO_DESTINATION,
                )

        # credit the last hop
        if cur_b.is_native():
            destination.mut().balance += cur_b_received
            destination.store_change(delta, db)
        else:
            if bypass_issuer_check:
                dest_line = TrustFrame.load_trust_line(pp.destination, cur_b, db)
            else:
                dest_line, issuer = TrustFrame.load_trust_line_issuer(
                    pp.destination, cur_b, db
                )
                if issuer is None:
                    return self._fail(
                        metrics,
                        "no-issuer",
                        PathPaymentResultCode.PATH_PAYMENT_NO_ISSUER,
                        cur_b,
                    )
            if dest_line is None:
                return self._fail(
                    metrics, "no-trust", PathPaymentResultCode.PATH_PAYMENT_NO_TRUST
                )
            if not dest_line.is_authorized():
                return self._fail(
                    metrics,
                    "not-authorized",
                    PathPaymentResultCode.PATH_PAYMENT_NOT_AUTHORIZED,
                )
            if not dest_line.add_balance(cur_b_received):
                return self._fail(
                    metrics, "line-full", PathPaymentResultCode.PATH_PAYMENT_LINE_FULL
                )
            dest_line.store_change(delta, db)

        success.last = SimplePaymentResult(pp.destination, cur_b, cur_b_received)

        # walk the path backwards converting through the book
        for cur_a in reversed(full_path):
            if cur_a == cur_b:
                continue
            if not cur_a.is_native():
                if (
                    AccountFrame.load_account(
                        cur_a.code_and_issuer()[1], db, readonly=True
                    )
                    is None
                ):
                    return self._fail(
                        metrics,
                        "no-issuer",
                        PathPaymentResultCode.PATH_PAYMENT_NO_ISSUER,
                        cur_a,
                    )

            oe = OfferExchange(delta, lm)
            stop_code = []

            def offer_filter(o):
                if o.get_seller_id() == self.get_source_id():
                    metrics.new_meter(
                        ("op-path-payment", "failure", "offer-cross-self"), "operation"
                    ).mark()
                    stop_code.append(
                        PathPaymentResultCode.PATH_PAYMENT_OFFER_CROSS_SELF
                    )
                    return OfferFilterResult.STOP
                return OfferFilterResult.KEEP

            r, cur_a_sent, actual_b_received = oe.convert_with_offers(
                cur_a, INT64_MAX, cur_b, cur_b_received, offer_filter
            )
            if r == ConvertResult.FILTER_STOP:
                self.set_inner_result(PathPaymentResult(stop_code[0]))
                return False
            if r == ConvertResult.OK and cur_b_received == actual_b_received:
                pass
            else:
                return self._fail(
                    metrics,
                    "too-few-offers",
                    PathPaymentResultCode.PATH_PAYMENT_TOO_FEW_OFFERS,
                )

            cur_b_received = cur_a_sent
            cur_b = cur_a
            success.offers = oe.offer_trail + success.offers

        # finally: debit the source
        cur_b_sent = cur_b_received
        if cur_b_sent > pp.sendMax:
            return self._fail(
                metrics, "over-send-max", PathPaymentResultCode.PATH_PAYMENT_OVER_SENDMAX
            )

        if cur_b.is_native():
            min_balance = self.source_account.get_minimum_balance(lm)
            if self.source_account.get_balance() - cur_b_sent < min_balance:
                return self._fail(
                    metrics,
                    "underfunded",
                    PathPaymentResultCode.PATH_PAYMENT_UNDERFUNDED,
                )
            self.source_account.mut().balance -= cur_b_sent
            self.source_account.store_change(delta, db)
        else:
            if bypass_issuer_check:
                source_line = TrustFrame.load_trust_line(
                    self.get_source_id(), cur_b, db
                )
            else:
                source_line, issuer = TrustFrame.load_trust_line_issuer(
                    self.get_source_id(), cur_b, db
                )
                if issuer is None:
                    return self._fail(
                        metrics,
                        "no-issuer",
                        PathPaymentResultCode.PATH_PAYMENT_NO_ISSUER,
                        cur_b,
                    )
            if source_line is None:
                return self._fail(
                    metrics, "src-no-trust", PathPaymentResultCode.PATH_PAYMENT_SRC_NO_TRUST
                )
            if not source_line.is_authorized():
                return self._fail(
                    metrics,
                    "src-not-authorized",
                    PathPaymentResultCode.PATH_PAYMENT_SRC_NOT_AUTHORIZED,
                )
            if not source_line.add_balance(-cur_b_sent):
                return self._fail(
                    metrics, "underfunded", PathPaymentResultCode.PATH_PAYMENT_UNDERFUNDED
                )
            source_line.store_change(delta, db)

        metrics.new_meter(("op-path-payment", "success", "apply"), "operation").mark()
        return True
