"""Mean time, in ms, of a build's ``lite`` and ``full`` stages together
(lite and full materialisation with their compaction)."""
from litemat_bench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run, ("lite", "full"))
