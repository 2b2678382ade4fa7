"""Cross-process metrics aggregation — N process snapshots, ONE fleet view.

A :class:`~repro_torch.obs.metrics.MetricsRegistry` is strictly
per-process (or per-runtime): every process of a distributed job, and
every serving runtime with its own registry, produces its own snapshot,
and nothing could answer a fleet-level question ("what is the p99 across BOTH processes?", "how many
HBM bytes does the whole store hold?") without hand-eyeballing files.

This module combines any number of
:meth:`~repro_torch.obs.metrics.MetricsRegistry.mergeable_snapshot` documents
into one fleet snapshot with no information loss:

  * **counters sum** — monotonic event counts are additive across
    processes;
  * **histograms merge bucket-wise** — the log-bucket sketches share
    their geometric bucket boundaries (a process constant stamped into
    every snapshot as ``growth_log``), so merging is a per-index count
    sum: associative, commutative, and exactly the sketch the pooled
    observation stream would have produced;
  * **gauges label by process** — a point-in-time value (queue depth,
    HBM bytes) is NOT additive in general, so each gauge keeps its
    identity under an added ``process`` label; sums are the *reader's*
    choice (``scripts/fleet_report.py`` sums ``hbm_bytes`` because bytes
    on different shards genuinely add).

Mixed-schema inputs are rejected up front with a clear error: snapshots
from different code versions (schema string) or different bucket
geometries (``growth_log``) cannot be merged meaningfully, and a silent
best-effort merge would corrupt every percentile downstream.

CLI (combines per-process exports into ONE artifact)::

    python -m repro_torch.obs.aggregate --out fleet.json snap0.json snap1.json
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.metrics import (SNAPSHOT_SCHEMA_VERSION, merge_states,
                               summarize_state)

#: Wire-format version of an aggregated fleet snapshot.
FLEET_SCHEMA_VERSION = "repro.metrics.fleet/1"


class AggregationError(ValueError):
    """Incompatible snapshots — schema/bucket-geometry mismatch."""


def _entry_key(e: dict) -> tuple:
    return (e["name"], tuple(sorted(e.get("labels", {}).items())))


def check_compatible(snapshots: list) -> None:
    """Raise :class:`AggregationError` unless every snapshot merges.

    Checks: schema version, bucket geometry (``growth_log``), and
    process-name uniqueness (two snapshots claiming the same process would
    silently collide on every gauge label).
    """
    if not snapshots:
        raise AggregationError("no snapshots to aggregate")
    seen_procs: dict = {}
    for i, s in enumerate(snapshots):
        schema = s.get("schema")
        if schema != SNAPSHOT_SCHEMA_VERSION:
            raise AggregationError(
                f"snapshot[{i}] has schema {schema!r}, expected "
                f"{SNAPSHOT_SCHEMA_VERSION!r} — refusing to merge "
                "mixed-schema snapshots (re-export with matching code)")
        g0 = snapshots[0].get("growth_log")
        if s.get("growth_log") != g0:
            raise AggregationError(
                f"snapshot[{i}] bucket geometry growth_log="
                f"{s.get('growth_log')!r} != {g0!r} — sketches with "
                "different bucket boundaries cannot merge bucket-wise")
        proc = str(s.get("process", i))
        if proc in seen_procs:
            raise AggregationError(
                f"snapshot[{i}] and snapshot[{seen_procs[proc]}] both "
                f"claim process {proc!r} — every process must export "
                "under a unique name or gauges would collide")
        seen_procs[proc] = i


def aggregate(snapshots: list) -> dict:
    """Merge mergeable process snapshots into one fleet snapshot."""
    check_compatible(snapshots)

    counters: dict = {}
    gauges: list = []
    hists: dict = {}
    processes = []
    for s in snapshots:
        proc = str(s.get("process", len(processes)))
        processes.append(proc)
        for e in s.get("counters", ()):
            k = _entry_key(e)
            counters[k] = counters.get(k, 0) + int(e["value"])
        for e in s.get("gauges", ()):
            labels = dict(e.get("labels", {}))
            labels["process"] = proc
            gauges.append(dict(name=e["name"], labels=labels,
                               value=e["value"]))
        for e in s.get("histograms", ()):
            k = _entry_key(e)
            st = dict(buckets=e.get("buckets", {}), count=e.get("count", 0),
                      sum=e.get("sum", 0.0))
            if e.get("min") is not None:
                st["min"], st["max"] = e["min"], e["max"]
            prev = hists.get(k)
            hists[k] = merge_states(prev, st) if prev else merge_states(st)

    def hist_entry(k, st):
        name, labels = k
        cnt = st["count"]
        return dict(name=name, labels=dict(labels),
                    buckets={str(b): c
                             for b, c in sorted(st["buckets"].items())},
                    count=cnt, sum=st["sum"],
                    min=st["min"] if cnt else None,
                    max=st["max"] if cnt else None,
                    summary=summarize_state(st))

    return {
        "schema": FLEET_SCHEMA_VERSION,
        "growth_log": snapshots[0].get("growth_log"),
        "processes": processes,
        "counters": [dict(name=k[0], labels=dict(k[1]), value=v)
                     for k, v in sorted(counters.items())],
        "gauges": sorted(gauges, key=_entry_key),
        "histograms": [hist_entry(k, st)
                       for k, st in sorted(hists.items())],
    }


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-process metrics snapshots into ONE fleet "
                    "snapshot (counters sum, histograms merge bucket-wise, "
                    "gauges label by process).")
    ap.add_argument("snapshots", nargs="+",
                    help="per-process mergeable snapshot JSON files")
    ap.add_argument("--out", required=True, help="fleet snapshot output path")
    args = ap.parse_args(argv)

    from repro_torch.obs.export import validate_metrics_snapshot

    snaps = []
    for path in args.snapshots:
        snap = load_snapshot(path)
        errors = validate_metrics_snapshot(snap)
        if errors:
            for e in errors:
                print(f"{path}: {e}", file=sys.stderr)
            return 1
        snaps.append(snap)
    try:
        fleet = aggregate(snaps)
    except AggregationError as e:
        print(f"aggregate: {e}", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(fleet, f, indent=1, sort_keys=True)
    print(f"# wrote {args.out}: {len(snaps)} processes, "
          f"{len(fleet['counters'])} counters, {len(fleet['gauges'])} "
          f"gauges, {len(fleet['histograms'])} histograms")
    return 0


__all__ = ["FLEET_SCHEMA_VERSION", "AggregationError", "aggregate",
           "check_compatible", "load_snapshot", "main"]

if __name__ == "__main__":
    sys.exit(main())
