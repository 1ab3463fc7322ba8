"""setup_s: from the start of the process to the end of the warm-up: the
imports, the kernels' build where it has not run, making the traffic,
building the system under test and warming up every call shape."""


def read(ctx):
    return ctx.setup_s
