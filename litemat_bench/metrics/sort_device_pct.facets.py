"""Share, in %, of the window's kernel time in sort kernels."""
from litemat_bench.devtrace import sort_pct


def read(run):
    return sort_pct(run)
