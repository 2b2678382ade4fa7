"""Mean time, in ms, of the ``encode`` stage of a build (the dictionary and
the ABox encode), over the builds in the window."""
from litemat_bench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run, ("encode",))
