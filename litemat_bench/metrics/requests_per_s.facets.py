"""Requests answered ``ok`` within the window, over the window's seconds.

Per-layer, in the traced run: the rate is paced by the host's copies of the
type column in ``TypeIndex.range_of`` and spread by 15-24% between runs of
one machine, more than the largest end-to-end bound allows."""


def read(run):
    if run.kind != "serve_closed_loop":
        return None
    ok = sum(r["status"] == "ok" and r["t_done"] <= run.t_close
             for r in run.requests)
    return ok / (run.t_close - run.t_open)
