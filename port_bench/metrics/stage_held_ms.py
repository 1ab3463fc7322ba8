"""stage_held_ms: the GIL-held part of the C host stage a chunk, in ms: the
program's ``ed25519.stage_prologue`` (argument parsing, the walk over the
chunk's tuples, the increfs) and ``ed25519.stage_epilogue`` (the decrefs)
spans summed over the traced window, over the number of stage calls.  The
spans come from the stage's own clock stamps (``native/sighash.c``)."""

PROLOGUE, EPILOGUE = "ed25519.stage_prologue", "ed25519.stage_epilogue"


def read(ctx):
    calls = sum(1 for n, _, _ in ctx.spans if n == PROLOGUE)
    held = sum(b - a for n, a, b in ctx.spans if n in (PROLOGUE, EPILOGUE))
    return 1e3 * held / calls if calls else None
