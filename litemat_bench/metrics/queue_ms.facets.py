"""Mean time, in ms, a request waited in the runtime's admission queue (the
runtime's ``queue`` span), over the requests resolved in the window."""
from litemat_bench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run, ("queue",))
