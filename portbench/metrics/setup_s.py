"""Process start to the first timed dispatch: imports, the scene, its
tables on the card, the library's load (its build in a fresh checkout)
and the warm-up dispatch."""

SPANS = ()


def read(ctx):
    return ctx.setup_s
