"""The project-contract rules (Python side).

Each rule encodes one load-bearing convention of the project; the docstring
on each class is the contract statement, the ``doc`` string the one-liner
the CLI prints.  All of them walk the shared parent-annotated AST in
``FileContext`` — no rule re-parses.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from .core import FileContext, attr_chain
from .registry import Rule, register

Hit = Tuple[int, str]

# typed-alias attributes EntryFrame subclasses expose over the wrapped
# LedgerEntry (entryframe.py _rebind_entry contract)
ENTRY_ALIASES = {"entry", "account", "trust_line", "offer"}
# in-place container mutators that dodge an attribute-store pattern match
CONTAINER_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "clear", "sort", "reverse",
}
# the sanctioned CoW entry points: writes inside these methods ARE the
# seal/unseal machinery
COW_SANCTIONED_FUNCS = {"mut", "touch", "_rebind_entry"}


def _walk(ctx: FileContext):
    return ast.walk(ctx.tree)


@register
class CowMutationRule(Rule):
    """Seal-on-store CoW discipline: after a store, ``frame.entry``
    IS the shared immutable snapshot in the delta/entry-cache/store-buffer.
    Any in-place write THROUGH a typed alias (``f.account.balance = v``,
    ``f.entry.data.value = body``, ``f.account.signers.append(s)``) that
    does not route through ``mut()``/``touch()`` can mutate that shared
    snapshot and fork the ledger hash.  Reads through the alias are free;
    writes must use ``f.mut().field = v`` or a sanctioned frame method."""

    id = "cow-mutation"
    doc = (
        "entry-field write through an EntryFrame typed alias outside"
        " mut()/touch()/_rebind_entry — can mutate a sealed shared snapshot"
    )

    def _alias_links(self, chain) -> bool:
        # alias must appear as an intermediate ATTRIBUTE link (position >=1,
        # before the final member): `f.account.balance` hits, a mut()-result
        # local (`account.flags |= x`) and alias REBINDS (`self.offer = ...`)
        # don't
        return any(link in ENTRY_ALIASES for link in chain[1:-1])

    def _ok_context(self, ctx: FileContext, node: ast.AST, chain) -> bool:
        if any(link in ("mut()", "touch()") for link in chain):
            return True
        return ctx.enclosing_function(node) in COW_SANCTIONED_FUNCS

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        for node in _walk(ctx):
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = (node.target,)
            elif isinstance(node, ast.Delete):
                targets = tuple(node.targets)
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in CONTAINER_MUTATORS
                ):
                    chain = attr_chain(f.value)
                    if (
                        chain
                        and any(l in ENTRY_ALIASES for l in chain[1:])
                        and not self._ok_context(ctx, node, chain)
                    ):
                        yield (
                            node.lineno,
                            f"in-place {f.attr}() through entry alias"
                            f" `{'.'.join(chain)}` — CoW-unseal with"
                            " mut()/touch() first",
                        )
                continue
            for t in targets:
                stack = [t]
                while stack:
                    tgt = stack.pop()
                    if isinstance(tgt, (ast.Tuple, ast.List)):
                        stack.extend(tgt.elts)
                        continue
                    if isinstance(tgt, ast.Starred):
                        stack.append(tgt.value)
                        continue
                    if isinstance(tgt, ast.Subscript):
                        # `f.account.signers[0] = s` / `del f.entry...[i]` /
                        # `...signers[:] = []`: the mutated container IS the
                        # chain under the subscript, so the alias may sit at
                        # ANY attribute link of it (incl. the last)
                        chain = attr_chain(tgt.value)
                        if (
                            chain
                            and any(l in ENTRY_ALIASES for l in chain[1:])
                            and not self._ok_context(ctx, tgt, chain)
                        ):
                            yield (
                                tgt.lineno,
                                f"subscript write through entry alias"
                                f" `{'.'.join(chain)}[...]` — CoW-unseal"
                                " with mut()/touch() first",
                            )
                        continue
                    if not isinstance(tgt, ast.Attribute):
                        continue
                    chain = attr_chain(tgt)
                    if (
                        chain
                        and self._alias_links(chain)
                        and not self._ok_context(ctx, tgt, chain)
                    ):
                        yield (
                            tgt.lineno,
                            f"direct write to `{'.'.join(chain)}` bypasses"
                            " the CoW seal — route through"
                            " .mut().<field> = ... (or touch() first)",
                        )


@register
class TrustedGetfieldRule(Rule):
    """The raw-XDR hot-field accessors (``cxdrpack.getfield``) skip
    full decode and therefore skip full VALIDATION — they are accessors,
    not validators, and belong on the TRUSTED post-verify plane only
    (herder own-state reads, fuzz mutant generation).  In the untrusted
    ingest plane (overlay, pending-envelope intake) a getfield turns
    malformed tails into wedged fetch dependencies; ingest keeps full
    decode (pendingenvelopes.py documents the choice)."""

    id = "trusted-getfield"
    doc = (
        "xdr_getfield/xdr_setfield (raw-XDR accessors) used in the"
        " pre-verify ingest plane — full decode is the validator there"
    )

    SCOPED = ("overlay/",)
    SCOPED_FILES = ("herder/pendingenvelopes.py",)

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(self.SCOPED) or ctx.relpath in self.SCOPED_FILES

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        for node in _walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = None
            if isinstance(f, ast.Name) and f.id in ("xdr_getfield", "xdr_setfield"):
                name = f.id
            elif isinstance(f, ast.Attribute) and f.attr in ("getfield", "setfield"):
                name = f.attr
            if name:
                yield (
                    node.lineno,
                    f"{name}() in the pre-verify plane — raw-XDR accessors"
                    " are TRUSTED-plane only; fully decode untrusted input",
                )


@register
class CacheLatchRule(Rule):
    """The shared verify cache is consensus state: a verdict that enters it
    from an aborted/forked close poisons every later lookup.  The
    contract: batch verdicts latch ONLY inside the future's completion
    (under its lock, where ``quarantine()`` can win the race) or on the
    synchronous ``CachingSigBackend`` path.  Any other ``put``/``put_many``
    /``drop_many`` on a verify cache bypasses the quarantine plane."""

    id = "cache-latch"
    doc = (
        "VerifySigCache write outside the CachingSigBackend/SigFlushFuture/"
        "HalfAggScheme completion/latch paths — bypasses the quarantine"
        " contract"
    )

    WRITES = {"put", "put_many", "drop_many"}
    # HalfAggScheme (crypto/aggregate/scheme.py): an aggregate-
    # accepted slot bucket latches its verdicts synchronously on the
    # caller's thread, and ONLY True verdicts can reach that latch
    # (completeness of the half-aggregation check is exact) — the same
    # valid-only contract as the synchronous CachingSigBackend path, with
    # no async future to quarantine.
    # IngestPlane (ingest/plane.py): the admission flush owns its
    # own peek/verify/latch split (unwrapping CachingSigBackend would
    # re-hash and re-peek every key on the miss path) and latches
    # synchronously on the caller's crank with the identical valid-only
    # filter (`... if ok`) — a flooded batch of invalid-sig txs leaves
    # no verdicts behind.  Fixtures: cache_latch_{pos,neg}.py; contract
    # record in SWEEP.md.
    LATCH_CLASSES = {
        "VerifySigCache",
        "CachingSigBackend",
        "SigFlushFuture",
        "HalfAggScheme",
        "IngestPlane",
    }

    def applies(self, ctx: FileContext) -> bool:
        # only modules that touch the verify-cache plane at all; EntryCache
        # etc. live in modules that never reference it
        return "VerifySigCache" in ctx.text or "verify_cache" in ctx.text

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        for node in _walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in self.WRITES):
                continue
            if not self._cacheish(f.value):
                continue  # queue.put / dict-wrapper puts are not this rule
            if ctx.enclosing_class(node) in self.LATCH_CLASSES:
                continue
            chain = attr_chain(f) or ["?", f.attr]
            yield (
                node.lineno,
                f"`{'.'.join(chain)}` writes the verify cache outside the"
                " latch classes — quarantined batches must never leave"
                " verdicts behind",
            )

    @staticmethod
    def _cacheish(recv: ast.AST) -> bool:
        """Receiver must look like a verify cache (`self.cache`,
        `_verify_cache`, `verify_cache()`); a work queue's .put() in the
        same module is not a latch violation."""
        chain = attr_chain(recv)
        if not chain:
            return True  # opaque receiver: flag, let a rationale decide
        return any("cache" in link.lower() for link in chain)


@register
class LockedFieldRule(Rule):
    """Fields registered with a ``# analysis: locked-by <lock>`` comment on
    their declaration (SigFlushFuture latch state, the tpu backend's wedge
    latch, the verify cache's map) are shared across threads; every access
    outside ``__init__`` must sit under a ``with <lock>`` block.  The
    registry comment is the rule's input — new threaded state opts in at
    its declaration site."""

    id = "locked-field"
    doc = (
        "access to a `# analysis: locked-by <lock>` registered field"
        " outside a `with <lock>` block (construction excepted)"
    )

    def applies(self, ctx: FileContext) -> bool:
        return bool(ctx.locked)

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        for node in _walk(ctx):
            if not isinstance(node, ast.Attribute):
                continue
            reg = ctx.locked.get(node.attr)
            if reg is None:
                continue
            lock, decl_line = reg
            if node.lineno == decl_line:
                continue
            if ctx.enclosing_function(node) == "__init__":
                # construction happens-before publication to other threads
                continue
            if ctx.in_with_lock(node, lock):
                continue
            chain = attr_chain(node) or ["?", node.attr]
            yield (
                node.lineno,
                f"`{'.'.join(chain)}` accessed outside `with {lock}` —"
                f" declared locked-by {lock} at line {decl_line}",
            )


@register
class DeterminismRule(Rule):
    """Consensus code runs on the VirtualClock: absolute time comes from
    ``app.clock.now()`` and randomness from seeded generators, or two
    validators (and two test runs) diverge.  Wall-clock reads
    (``time.time``, ``datetime.now``) and module-level ``random.*`` calls
    in the consensus planes (scp/herder/ledger) and their input planes
    (overlay/history) are violations; monotonic duration stamps
    (``perf_counter``/``monotonic``) are telemetry and stay legal."""

    id = "determinism"
    doc = (
        "wall-clock (time.time/datetime.now) or unseeded random.* in a"
        " consensus-adjacent module — VirtualClock/seeded-RNG discipline"
    )

    # simulation/ + scenarios/ joined later: the chaos plane's replay
    # contract (same topology + seed + fault program ⇒ same run) holds
    # only if every roll in the harness itself is seeded and all time
    # flows through the clock.  ingest/ joined after them: the admission
    # plane's deadline flushes and token buckets must ride the
    # VirtualClock or the scenario digests stop replaying.
    SCOPED = (
        "scp/", "herder/", "ledger/", "overlay/", "history/",
        "simulation/", "scenarios/", "ingest/",
    )
    DATETIME_CALLS = {"now", "utcnow", "today"}

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(self.SCOPED)

    @staticmethod
    def _from_imports(ctx: FileContext):
        """local-name -> ('time'|'random'|'datetime', original-name) for
        from-imports that would otherwise bypass the attribute-chain match
        (`from time import time; time()`)."""
        out = {}
        for node in _walk(ctx):
            if isinstance(node, ast.ImportFrom) and node.module in (
                "time",
                "random",
                "datetime",
            ):
                for alias in node.names:
                    out[alias.asname or alias.name] = (node.module, alias.name)
        return out

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        from_imports = self._from_imports(ctx)
        for node in _walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            if len(chain) < 2:
                hit = self._bare_call(node, chain[0], from_imports)
                if hit:
                    yield hit
                continue
            # `from datetime import datetime as dt; dt.now()` — resolve the
            # base name through the import map before the chain checks
            base_mod, base_name = from_imports.get(
                chain[0].rstrip("()"), (None, None)
            )
            if base_mod == "datetime" and base_name == "datetime":
                chain = ["datetime"] + chain[1:]
            if chain == ["time", "time"]:
                yield (
                    node.lineno,
                    "time.time() in a consensus-adjacent module — use"
                    " app.clock.now() (VirtualClock discipline)",
                )
            elif chain[0] == "datetime" and chain[-1] in self.DATETIME_CALLS:
                yield (
                    node.lineno,
                    f"datetime.{chain[-1]}() reads the wall clock — use"
                    " app.clock.now()",
                )
            elif chain[0] == "random" and len(chain) == 2:
                fn = chain[1]
                if fn == "Random" and (node.args or node.keywords):
                    continue  # seeded generator construction is the fix
                yield (
                    node.lineno,
                    f"module-level random.{fn} in a"
                    " consensus-adjacent module — use a seeded"
                    " random.Random instance",
                )

    def _bare_call(self, node: ast.Call, name: str, from_imports):
        """`from time import time; time()` / `from random import choice;
        choice(...)` — the from-import forms of the same wall-clock /
        unseeded-randomness reads."""
        name = name.rstrip("()")
        mod, orig = from_imports.get(name, (None, None))
        if mod == "time" and orig == "time":
            return (
                node.lineno,
                "time() (from-imported time.time) in a consensus-adjacent"
                " module — use app.clock.now() (VirtualClock discipline)",
            )
        if mod == "datetime" and orig in self.DATETIME_CALLS:
            return (
                node.lineno,
                f"{orig}() reads the wall clock — use app.clock.now()",
            )
        if mod == "random":
            if orig == "Random" and (node.args or node.keywords):
                return None  # seeded generator construction is the fix
            return (
                node.lineno,
                f"{orig}() (from-imported random.{orig}) in a"
                " consensus-adjacent module — use a seeded random.Random"
                " instance",
            )
        return None


@register
class SendPathRule(Rule):
    """The overlay survival plane: ``Peer.send_message`` → SendQueue
    is the ONLY legal outbound path.  MAC sequence numbers are assigned at
    the queue's drain (``sendqueue._emit``), so a direct ``send_frame()``
    call anywhere else either double-assigns a sequence number or sends
    un-MAC'd bytes, and it bypasses the byte caps, the class priorities,
    and the straggler detection — the exact unbounded-buffer hole the
    plane closes.  ``out_queue.append`` is the loopback transport's
    internal frame motion and belongs to its drain methods only."""

    id = "send-path"
    doc = (
        "direct send_frame()/out_queue.append() outside sendqueue.py and"
        " the transport drains — the bounded priority queue is the only"
        " legal send path"
    )

    # the queue's _emit is the single sanctioned send_frame caller
    QUEUE_FILE = "overlay/sendqueue.py"
    # transport-internal out_queue motion: the loopback drain itself
    DRAIN_FUNCS = {
        "overlay/loopback.py": {"send_frame", "deliver_one"},
    }

    def applies(self, ctx: FileContext) -> bool:
        if ctx.relpath == self.QUEUE_FILE:
            return False
        return "send_frame" in ctx.text or "out_queue" in ctx.text

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        drain_funcs = self.DRAIN_FUNCS.get(ctx.relpath, set())
        for node in _walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr == "send_frame":
                yield (
                    node.lineno,
                    "direct send_frame() bypasses the SendQueue choke"
                    " point (caps, class priority, straggler detection,"
                    " drain-time MAC sequencing) — route through"
                    " peer.send_message()",
                )
            elif f.attr == "append":
                chain = attr_chain(f.value)
                if not chain or "out_queue" not in chain:
                    continue
                if ctx.enclosing_function(node) in drain_funcs:
                    continue
                yield (
                    node.lineno,
                    "out_queue.append() outside the loopback transport"
                    " drain — frames must enter the wire through the"
                    " SendQueue's release",
                )


@register
class DurableWriteRule(Rule):
    """The crash-survival contract: durable artifacts — bucket
    files, history staging, persisted state files — reach disk ONLY
    through util/fs.py's write-tmp → fsync → rename → fsync-dir helpers
    (or the durable XDROutputFileStream), which also carry the named
    storage kill-points the kill-sweep proves recovery against.  A bare
    ``open(path, "w"/"wb"/"a")`` or raw ``os.rename``/``os.replace`` in
    the durable-artifact packages (bucket/, history/, main/) writes a
    file a kill can tear with no fault-injection coverage and no
    fsync/atomic-rename discipline — exactly the class of hole the boot
    self-check exists to repair."""

    id = "durable-write"
    doc = (
        "bare open(.., 'w*'/'a*') or os.rename/os.replace on a durable"
        " artifact (bucket/, history/, main/) — route through util/fs.py"
        " so the write is crash-safe and kill-point covered"
    )

    SCOPED = ("bucket/", "history/", "main/")
    WRITE_MODES_PREFIX = ("w", "a", "x")
    RENAMES = {"rename", "replace"}

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(self.SCOPED)

    @staticmethod
    def _mode_of(node: ast.Call):
        """The mode literal of an open() call, or None when absent or
        dynamic (dynamic modes are flagged conservatively by returning
        the sentinel '?')."""
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if mode is None:
            return None  # default 'r'
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value
        return "?"

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        for node in _walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id == "open":
                mode = self._mode_of(node)
                if mode is None:
                    continue  # read mode
                if mode == "?" or mode.startswith(self.WRITE_MODES_PREFIX):
                    yield (
                        node.lineno,
                        f"bare open(..., {mode!r}) writes a durable"
                        " artifact with no fsync/rename discipline and"
                        " no kill-point — use fs.durable_write/"
                        "stage_write (or a durable XDROutputFileStream)",
                    )
            elif isinstance(f, ast.Attribute) and f.attr in self.RENAMES:
                chain = attr_chain(f)
                if chain and chain[0] == "os":
                    yield (
                        node.lineno,
                        f"raw os.{f.attr}() places a durable artifact"
                        " without fsync(file)+fsync(dir) or a kill-point"
                        " — use fs.durable_rename",
                    )


@register
class MetricsFastLaneRule(Rule):
    """The metrics fast lane keeps a close-path record at one tuple +
    deque append; registry-built metrics (``app.metrics.new_*``) ride it.
    A bare ``Timer()``/``Meter()``/``Histogram()`` in a close-path module
    takes the direct (slow) path per call, and a ``to_json()``/``_apply*``
    there forces the reservoir/EWMA drain inline with the close."""

    id = "metrics-fast-lane"
    doc = (
        "slow-path medida call in a close-path module — lane-less metric"
        " construction or an inline drain (to_json/_apply) on the close path"
    )

    SCOPED = ("ledger/", "tx/")
    BARE_CTORS = {"Timer", "Meter", "Histogram"}
    DRAINS = {"to_json", "_apply", "_apply_batch"}

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith(self.SCOPED)

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        for node in _walk(ctx):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in self.BARE_CTORS:
                yield (
                    node.lineno,
                    f"bare {f.id}() is lane-less (per-call reservoir/EWMA"
                    " work) — use app.metrics.new_"
                    f"{f.id.lower()}(...) so records ride the fast lane",
                )
            elif isinstance(f, ast.Attribute) and f.attr in self.DRAINS:
                # metric-shaped receivers only: to_json/_apply exist on
                # many objects (deltas, codecs) that are not metrics
                if not self._metricish(f.value):
                    continue
                yield (
                    node.lineno,
                    f".{f.attr}() drains/serializes metrics inline on the"
                    " close path — reads belong on the admin plane",
                )

    @staticmethod
    def _metricish(recv: ast.AST) -> bool:
        chain = attr_chain(recv)
        if not chain:
            return True  # can't tell; flag and let a rationale decide
        text = ".".join(chain).lower()
        return any(
            k in text for k in ("metric", "timer", "meter", "histogram", "counter")
        )


@register
class ApplyShardIsolationRule(Rule):
    """Parallel-apply worker isolation: a function whose ``def``
    line carries an ``# analysis: shard-leg`` comment runs concurrently
    against per-shard planes (ShardView cache/buffer/frame-context) and
    must receive every plane it touches as an explicit parameter.  Inside
    the leg, reaching for a ``.database`` attribute, calling any SQL
    surface (``execute``/``query_one``/...), or resolving a plane through
    a global accessor (``entry_cache_of``/``active_buffer``/...) is a
    main-plane dependency that the footprint partition cannot see — it
    either races the other shards or silently reads pre-apply state.
    The registry comment is the rule's input: new worker legs opt in on
    their ``def`` line."""

    id = "apply-shard-isolation"
    doc = (
        "main-plane access inside an `# analysis: shard-leg` worker —"
        " `.database`, a SQL-surface call, or a plane-accessor lookup"
    )

    MARKER = "analysis: shard-leg"
    # the ShardView raises FootprintEscape on these at runtime; the rule
    # catches the dependency at review time instead
    SQL_SURFACE = {
        "execute", "executemany", "query_one", "query_all",
        "materialize_savepoints", "flush", "flush_through",
    }
    # module-level accessors that resolve the MAIN planes off a database
    PLANE_ACCESSORS = {
        "entry_cache_of", "active_buffer", "active_frame_context",
        "apply_scheduler_of",
    }

    def applies(self, ctx: FileContext) -> bool:
        return not ctx.is_c and self.MARKER in ctx.text

    def check(self, ctx: FileContext) -> Iterator[Hit]:
        marked = {
            line for line, text in ctx.comments.items() if self.MARKER in text
        }
        if not marked:
            return
        legs = []
        for node in _walk(ctx):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.lineno in marked:
                    marked.discard(node.lineno)
                    legs.append(node)
        for line in sorted(marked):
            yield (
                line,
                "`# analysis: shard-leg` must sit on the worker's `def`"
                " line — the marker registers the whole function body",
            )
        for leg in legs:
            yield from self._check_leg(leg)

    def _check_leg(self, leg: ast.AST) -> Iterator[Hit]:
        for node in ast.walk(leg):
            if isinstance(node, ast.Attribute) and node.attr == "database":
                chain = attr_chain(node) or ["?", "database"]
                yield (
                    node.lineno,
                    f"`{'.'.join(chain)}` inside shard-leg `{leg.name}` —"
                    " worker legs take their shard planes as parameters,"
                    " never resolve them off an app/manager",
                )
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in self.SQL_SURFACE:
                    chain = attr_chain(f) or ["?", f.attr]
                    yield (
                        node.lineno,
                        f"`{'.'.join(chain)}()` inside shard-leg"
                        f" `{leg.name}` — SQL bypasses the shard overlay;"
                        " reads outside the static footprint must raise"
                        " FootprintEscape, not hit the main store",
                    )
                elif isinstance(f, ast.Name) and f.id in self.PLANE_ACCESSORS:
                    yield (
                        node.lineno,
                        f"`{f.id}(...)` inside shard-leg `{leg.name}`"
                        " resolves a MAIN plane — the shard's own"
                        " cache/buffer/frame-context arrive as parameters",
                    )
