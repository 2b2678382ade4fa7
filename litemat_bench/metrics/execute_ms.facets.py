"""Mean time, in ms, of a request's ``execute`` span: its batch's
``QueryServer`` call (host searches, device plan, copies to the host)."""
from litemat_bench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run, ("execute",))
