"""Ledger state machine (reference: src/ledger/, SURVEY.md §2.5)."""

from .accountframe import AccountFrame  # noqa: F401
from .delta import LedgerDelta  # noqa: F401
from .entryframe import EntryFrame  # noqa: F401
from .headerframe import LedgerHeaderFrame  # noqa: F401
from .offerframe import OfferFrame  # noqa: F401
from .trustframe import TrustFrame  # noqa: F401
