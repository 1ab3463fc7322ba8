"""XDR wire protocol: runtime + the six Stellar-*.x type modules.

Replaces the reference's lib/xdrpp + xdrc codegen (src/Makefile.am:15-19)
with declarative Python; byte-exact with xdrpp's encoding.
"""

from .base import XdrError, pack, unpack, xdr_to_opaque  # noqa: F401
from .xtypes import *  # noqa: F401,F403
from .scp import *  # noqa: F401,F403
from .entries import *  # noqa: F401,F403
from .txs import *  # noqa: F401,F403
from .ledger import *  # noqa: F401,F403
from .overlay import *  # noqa: F401,F403
