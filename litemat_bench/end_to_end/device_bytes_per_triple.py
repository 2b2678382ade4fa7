"""Peak device bytes allocated over the configuration's raw triples.

A bulk load's peak is that of its window's builds.  A serving peak is taken
from the end of the build: the store and its views with the workspace of
the widest batch the runtime can form, which the warm-up runs, or of a
wider one in the window."""


def read(run):
    return run.peak_bytes / run.n_raw if run.peak_bytes else None
