"""Fuzzer stub — seed generation + replay into a loopback pair
(reference: src/main/fuzz.cpp, docs/fuzzing.md).

Two modes, intended to sit under an external fuzzer (AFL-style):

- ``gen_fuzz(path)``: write a few random StellarMessages (XDR record
  stream) as corpus seeds.
- ``fuzz(path)``: boot two standalone Applications joined by a
  LoopbackPeerConnection, crank until authenticated, then inject each
  message from the file into the initiator's SEND path one by one,
  cranking between messages.  Undecodable records are replaced with a
  HELLO-shaped message (fuzz.cpp tryRead) so mutated inputs keep flowing.
  Exits when input is exhausted or the acceptor drops the peer.
"""

from __future__ import annotations

import random

from ..crypto import sha256
from ..util import xlog
from ..util.xdrstream import XDRInputFileStream, XDROutputFileStream
from ..xdr.arbitrary import arbitrary_of
from ..xdr.base import XdrError
from ..xdr.overlay import MessageType, StellarMessage

log = xlog.logger("Overlay")


def msg_summary(m: StellarMessage) -> str:
    return f"{m.type.name}:{sha256(m.to_xdr()).hex()[:8]}"


def _mutate_one_field(m: StellarMessage, rng: random.Random):
    """A structurally-valid single-field mutant of `m`, via the C setfield
    accessor over the packed bytes (native/cxdrpack.c) — structured
    mutation that survives XDR decode, so it exercises the SEMANTIC
    validation planes the byte-flip fuzz path bounces off.  Only
    fixed-width scalar paths are mutable in place (setfield's contract)."""
    from ..xdr import base as B
    from ..xdr.base import iter_scalar_field_paths, xdr_setfield

    data = m.to_xdr()
    codec = B.codec_of(m)
    paths = [
        (p, leaf)
        for p, leaf, _v in iter_scalar_field_paths(codec, m)
        if isinstance(
            leaf,
            (B._UInt32, B._Int32, B._UInt64, B._Int64, B._Bool, B._Enum,
             B._Opaque),
        )
    ]
    if not paths:
        return None
    path, leaf = paths[rng.randrange(len(paths))]
    if isinstance(leaf, B._Enum):
        val = rng.choice(list(leaf.enum_cls))
    elif isinstance(leaf, B._Bool):
        val = rng.random() < 0.5
    elif isinstance(leaf, B._Opaque):
        val = rng.randbytes(leaf.n)
    elif isinstance(leaf, (B._UInt32, B._UInt64)):
        bits = 32 if isinstance(leaf, B._UInt32) else 64
        val = rng.getrandbits(rng.choice((1, 8, bits)))
        val &= (1 << bits) - 1
    else:
        bits = 32 if isinstance(leaf, B._Int32) else 64
        val = rng.getrandbits(bits - 1) - rng.getrandbits(bits - 1)
    try:
        return StellarMessage.from_xdr(xdr_setfield(codec, data, path, val))
    except XdrError:
        return None  # e.g. bad-union mutant: structurally undecodable


def gen_fuzz(filename: str, n: int = 3, seed: int = None) -> None:
    rng = random.Random(seed)
    log.info("writing %d-message random fuzz file %s", n, filename)
    with XDROutputFileStream(filename) as out:
        written = 0
        while written < n:
            m = arbitrary_of(StellarMessage, 10, rng)
            try:
                m.to_xdr()
            except XdrError:
                continue  # malformed, omitted (fuzz.cpp genfuzz)
            out.write_one(m)
            log.info("message %d: %s", written, msg_summary(m))
            written += 1
            # every other seed also gets a single-field setfield mutant:
            # same structure, one scalar off — the shape byte-flips rarely
            # reach (they usually break decode before semantics)
            if written < n and rng.random() < 0.5:
                mut = _mutate_one_field(m, rng)
                if mut is not None:
                    out.write_one(mut)
                    log.info("message %d: %s (field mutant)",
                             written, msg_summary(mut))
                    written += 1


def _try_read(stream: XDRInputFileStream):
    """Next message, substituting GET_PEERS for undecodable records."""
    try:
        return stream.read_one(StellarMessage)
    except XdrError as e:
        # the reference substitutes a default HELLO; our HELLO arm carries a
        # struct, so the simplest always-packable stand-in is GET_PEERS
        log.info("caught XDR error %r on input, substituting GET_PEERS", str(e))
        return StellarMessage(MessageType.GET_PEERS, None)


def fuzz(filename: str) -> int:
    from ..overlay.loopback import LoopbackPeerConnection
    from ..tx.testutils import get_test_config
    from ..util.clock import VirtualClock
    from .application import Application

    log.info("fuzz input is in %s", filename)
    clock = VirtualClock()
    cfg1 = get_test_config(90)
    cfg2 = get_test_config(91)
    # invariant plane in LOG mode: under the default `raise` policy a
    # violating close would throw out of clock.crank and kill the run
    # mid-corpus — here the close must survive so the rest of the input
    # keeps injecting, and the post-run oracle below turns any recorded
    # violation into rc=1 with the full /invariants context logged
    for cfg in (cfg1, cfg2):
        cfg.INVARIANT_FAIL_POLICY = "log"
    app1 = Application.create(clock, cfg1, new_db=True)
    app2 = Application.create(clock, cfg2, new_db=True)
    app1.start()
    app2.start()
    injected = 0
    try:
        loop = LoopbackPeerConnection(app1, app2)
        ok = clock.crank_until(
            lambda: loop.initiator.is_authenticated()
            and loop.acceptor.is_authenticated(),
            30,
        )
        if not ok:
            log.error("fuzz: loopback pair failed to authenticate")
            return 1
        with XDRInputFileStream(filename) as f:
            while True:
                msg = _try_read(f)
                if msg is None:
                    break
                injected += 1
                log.info("fuzzer injecting message %d: %s", injected, msg_summary(msg))
                try:
                    loop.initiator.send_message(msg)
                except XdrError:
                    log.info("message %d unsendable, skipped", injected)
                for _ in range(20):
                    clock.crank(block=False)
                if not loop.acceptor.is_connected():
                    log.info("acceptor dropped the peer after %d messages", injected)
                    break
        for _ in range(50):
            clock.crank(block=False)
    finally:
        app1.graceful_stop()
        app2.graceful_stop()
        clock.shutdown()
    # ledger-invariant oracle (stellar_tpu/invariant/): whatever the
    # mutated message stream made the pair do, every ledger they ACCEPTED
    # must hold the invariants — a violation here is a close-path bug the
    # fuzzer found, not a fuzz harness failure, so the run goes red
    violations = (
        app1.invariants.total_violations + app2.invariants.total_violations
    )
    if violations:
        for i, app in enumerate((app1, app2), 1):
            if app.invariants.total_violations:
                log.error("fuzz: app%d invariants: %r",
                          i, app.invariants.dump_info())
        log.error(
            "fuzz: %d ledger-invariant violation(s) on accepted ledgers",
            violations,
        )
        return 1
    log.info("fuzz run complete: %d messages injected", injected)
    return 0
