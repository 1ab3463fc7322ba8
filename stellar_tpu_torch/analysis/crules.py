"""C-side leg: token-level scan of the native extensions.

The three CPython extensions release the GIL around their hot loops
(``Py_BEGIN_ALLOW_THREADS`` … ``Py_END_ALLOW_THREADS``).  Inside such a
region NO CPython API may run — no refcounting, no ``PyErr_*``, no
allocation through ``PyMem_*`` — because another thread owns the
interpreter.  A violation here is a crash-or-corruption bug that only
reproduces under thread pressure, exactly the class that reading a long
diff misses.

The scanner strips comments/strings/preprocessor lines with a small state
machine (no C parser in the toolchain contract), tracks BEGIN/END nesting,
and flags any ``Py``/``_Py``-prefixed identifier inside a region except
the region markers themselves (and the documented BLOCK/UNBLOCK pair).
"""

from __future__ import annotations

import re
from typing import Iterator, List, Tuple

from .core import FileContext
from .registry import Rule, register

_IDENT = re.compile(r"\b_?Py[A-Za-z_0-9]*\b")
_REGION_OK = {
    "Py_BEGIN_ALLOW_THREADS",
    "Py_END_ALLOW_THREADS",
    "Py_BLOCK_THREADS",
    "Py_UNBLOCK_THREADS",
}


def strip_c_noise(lines: List[str]) -> List[str]:
    """Return lines with comments, string/char literals, and preprocessor
    directives blanked (same line count/offsets, so line numbers hold)."""
    out: List[str] = []
    in_block = False
    for raw in lines:
        buf = []
        i, n = 0, len(raw)
        # a preprocessor directive can't open a code region we care about
        if not in_block and raw.lstrip().startswith("#"):
            out.append("")
            continue
        while i < n:
            c = raw[i]
            if in_block:
                if c == "*" and i + 1 < n and raw[i + 1] == "/":
                    in_block = False
                    i += 2
                    continue
                i += 1
                continue
            if c == "/" and i + 1 < n and raw[i + 1] == "*":
                in_block = True
                i += 2
                continue
            if c == "/" and i + 1 < n and raw[i + 1] == "/":
                break  # line comment
            if c in "\"'":
                quote = c
                i += 1
                while i < n:
                    if raw[i] == "\\":
                        i += 2
                        continue
                    if raw[i] == quote:
                        i += 1
                        break
                    i += 1
                buf.append(" ")
                continue
            buf.append(c)
            i += 1
        out.append("".join(buf))
    return out


def scan_gil_regions(lines: List[str]) -> Iterator[Tuple[int, str]]:
    """(line, identifier) for every CPython API token inside a
    BEGIN/END_ALLOW_THREADS region.  Py_BLOCK_THREADS re-acquires the GIL
    until Py_UNBLOCK_THREADS, so CPython calls between THOSE are legal —
    tracked as a nested re-acquisition."""
    depth = 0  # GIL released when > 0
    reacq = 0  # Py_BLOCK_THREADS re-acquisitions inside a region
    for lineno, text in enumerate(strip_c_noise(lines), 1):
        for m in _IDENT.finditer(text):
            ident = m.group(0)
            if ident == "Py_BEGIN_ALLOW_THREADS":
                depth += 1
                continue
            if ident == "Py_END_ALLOW_THREADS":
                depth = max(0, depth - 1)
                if depth == 0:
                    reacq = 0
                continue
            if ident == "Py_BLOCK_THREADS":
                if depth > 0:
                    reacq += 1
                continue
            if ident == "Py_UNBLOCK_THREADS":
                reacq = max(0, reacq - 1)
                continue
            if depth > 0 and reacq == 0 and ident not in _REGION_OK:
                yield lineno, ident


@register
class GilRegionRule(Rule):
    """No CPython API inside a GIL-released region of the native
    extensions — borrow every pointer and finish every refcount/error-path
    touch before ``Py_BEGIN_ALLOW_THREADS`` (sighash.c's borrow_bytes
    pattern is the sanctioned shape)."""

    id = "gil-region"
    doc = (
        "CPython API identifier inside a Py_BEGIN/END_ALLOW_THREADS region"
        " of a native extension — the GIL is not held there"
    )
    is_c_rule = True

    def applies(self, ctx: FileContext) -> bool:
        return ctx.relpath.startswith("native/") and ctx.relpath.endswith(".c")

    def check(self, ctx: FileContext):
        for lineno, ident in scan_gil_regions(ctx.lines):
            yield (
                lineno,
                f"`{ident}` inside a GIL-released region — move it outside"
                " Py_BEGIN/END_ALLOW_THREADS or re-acquire with"
                " Py_BLOCK_THREADS",
            )
