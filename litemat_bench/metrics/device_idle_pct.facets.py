"""Share, in %, of the window in which no operation ran on the device: 100
x (1 - the union of the device operations' intervals over the window)."""
from litemat_bench.devtrace import idle_pct


def read(run):
    return idle_pct(run)
