"""Random XDR value generation — the xdrpp/autocheck equivalent
(reference: lib/xdrpp autocheck.h, used by --genfuzz and ItemFetcherTests).

Walks the declarative codec tree (xdr/base.py) and produces a random value
of any registered XDR type.  Sizes are bounded by a ``size`` fuel parameter
so nested var-arrays stay small, like autocheck's generator(10).
"""

from __future__ import annotations

import random
from typing import Any

from .base import (
    DepthLimited,
    XdrCodec,
    _Array,
    _Bool,
    _Enum,
    _Int32,
    _Int64,
    _Opaque,
    _Option,
    _String,
    _StructCodec,
    _UInt32,
    _UInt64,
    _UnionCodec,
    _VarArray,
    _VarOpaque,
)


def arbitrary(codec: XdrCodec, size: int = 10, rng: random.Random = None) -> Any:
    """A random value packable by ``codec``."""
    rng = rng or random.Random()
    return _gen(codec, size, rng)


def arbitrary_of(cls, size: int = 10, rng: random.Random = None) -> Any:
    return arbitrary(cls._codec, size, rng)


def _gen(codec: XdrCodec, size: int, rng: random.Random) -> Any:
    if isinstance(codec, DepthLimited):
        # shrink fast inside self-referential types so generation terminates
        return _gen(codec.inner, max(0, size - 4), rng)
    if isinstance(codec, _Bool):
        return rng.random() < 0.5
    if isinstance(codec, _UInt32):
        return rng.randrange(0, 1 << 32)
    if isinstance(codec, _Int32):
        return rng.randrange(-(1 << 31), 1 << 31)
    if isinstance(codec, _UInt64):
        return rng.randrange(0, 1 << 64)
    if isinstance(codec, _Int64):
        return rng.randrange(-(1 << 63), 1 << 63)
    if isinstance(codec, _String):
        n = rng.randrange(0, min(size, codec.maxlen) + 1)
        return "".join(chr(rng.randrange(32, 127)) for _ in range(n))
    if isinstance(codec, _VarOpaque):
        n = rng.randrange(0, min(size, codec.maxlen) + 1)
        return rng.randbytes(n)
    if isinstance(codec, _Opaque):
        return rng.randbytes(codec.n)
    if isinstance(codec, _Array):
        return [_gen(codec.elem, size // 2, rng) for _ in range(codec.n)]
    if isinstance(codec, _VarArray):
        n = rng.randrange(0, min(size, codec.maxlen) + 1)
        return [_gen(codec.elem, size // 2, rng) for _ in range(n)]
    if isinstance(codec, _Option):
        if rng.random() < 0.5:
            return None
        return _gen(codec.elem, size, rng)
    if isinstance(codec, _Enum):
        return rng.choice(list(codec.enum_cls))
    if isinstance(codec, _StructCodec):
        return codec.cls(
            **{name: _gen(c, size // 2, rng) for name, c in codec.fields}
        )
    if isinstance(codec, _UnionCodec):
        # normalized arms map disc -> codec-or-None(void); stick to known
        # arms unless the union tolerates unknown discriminants
        if not codec.arms or (codec.default_void and rng.random() < 0.1):
            # zero declared arms (e.g. AllowTrustResult: every code is
            # void) or an unknown-tolerant union probing a random value
            disc = _gen(codec.switch_codec, size, rng)
        else:
            disc = rng.choice(list(codec.arms))
        arm = codec.arms.get(disc)
        val = None if arm is None else _gen(arm, size // 2, rng)
        return codec.cls(disc, val)
    raise TypeError(f"no generator for codec {type(codec).__name__}")
