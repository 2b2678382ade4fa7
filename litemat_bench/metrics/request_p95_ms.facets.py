"""95th percentile, in ms, of issue-to-outcome time on the client's clock,
over every request that resolved within the window.  In a closed loop the
tail is mostly the requests in flight over the rate, and it swings more
than the rate does, so it is read beside the rate and holds no bound."""
from litemat_bench.stats import percentile


def read(run):
    if run.kind != "serve_closed_loop":
        return None
    lat = [r["t_done"] - r["t_issue"] for r in run.requests
           if r["t_done"] <= run.t_close]
    return 1e3 * percentile(lat, 95) if lat else None
