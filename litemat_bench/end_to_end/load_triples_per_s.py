"""Raw triples of every build in the window, over the window, which ends
when the build running at ``--seconds`` finishes."""


def read(run):
    if run.kind != "bulk_load" or not run.builds:
        return None
    return len(run.builds) * run.n_raw / (run.t_close - run.t_open)
