"""Mean number of requests a ``QueryServer`` call served in the window (the
program's ``server/batch_size`` histogram, both kinds)."""


def read(run):
    n = s = 0
    for (tag, name, _), (count, total) in run.hist.items():
        if tag == "process" and name == "server/batch_size":
            n, s = n + count, s + total
    return s / n if n else None
