"""JSON exporters + trace/metrics schema validation for the obs subsystem.

Three export surfaces:

  * :func:`export_traces` / :func:`export_metrics` — dump a Tracer's
    finished traces / a MetricsRegistry snapshot to JSON files
    (``chip_smoke.py``'s telemetry phase writes both).
  * :func:`export_mergeable_metrics` — one process's share of a FLEET
    snapshot (structured labels, raw histogram buckets); any number of
    these combine through :mod:`repro_torch.obs.aggregate`.
  * :data:`TRACE_SCHEMA` + :func:`validate_trace`, and
    :data:`METRICS_SNAPSHOT_SCHEMA` / :data:`FLEET_SNAPSHOT_SCHEMA` +
    :func:`validate_metrics_snapshot` — the contracts CI holds every
    exported trace AND metrics snapshot to (``scripts/check_traces.py``).
    The validator is a small hand-rolled subset of JSON Schema (type /
    properties / required / items / enum) because the container has no
    ``jsonschema`` package; on top of the schema walk it checks structural
    invariants a JSON schema can't express: exactly one root span, every
    parent_id resolves, every span's [t0, t1] is well ordered — and for
    metrics: every histogram's bucket counts reconcile with its total
    count, bucket indexes parse as integers, min <= max.
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import SNAPSHOT_SCHEMA_VERSION

#: Schema one exported trace object must satisfy (subset of JSON Schema).
TRACE_SCHEMA = {
    "type": "object",
    "required": ["trace_id", "spans"],
    "properties": {
        "trace_id": {"type": "string"},
        "spans": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["span_id", "parent_id", "name", "t0", "t1"],
                "properties": {
                    "span_id": {"type": "integer"},
                    "parent_id": {"type": "integer"},
                    "name": {"type": "string"},
                    "t0": {"type": "number"},
                    "t1": {"type": "number"},
                    "attrs": {"type": "object"},
                    "events": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["name", "t"],
                            "properties": {
                                "name": {"type": "string"},
                                "t": {"type": "number"},
                            },
                        },
                    },
                },
            },
        },
    },
}

_VALUE_ENTRY = {
    "type": "object",
    "required": ["name", "labels", "value"],
    "properties": {
        "name": {"type": "string"},
        "labels": {"type": "object"},
        "value": {"type": "number"},
    },
}

_HIST_ENTRY = {
    "type": "object",
    "required": ["name", "labels", "buckets", "count", "sum"],
    "properties": {
        "name": {"type": "string"},
        "labels": {"type": "object"},
        "buckets": {"type": "object"},
        "count": {"type": "integer"},
        "sum": {"type": "number"},
    },
}

#: Schema one per-process mergeable metrics snapshot must satisfy.
METRICS_SNAPSHOT_SCHEMA = {
    "type": "object",
    "required": ["schema", "growth_log", "process", "counters", "gauges",
                 "histograms"],
    "properties": {
        "schema": {"type": "string"},
        "growth_log": {"type": "number"},
        "process": {"type": "string"},
        "counters": {"type": "array", "items": _VALUE_ENTRY},
        "gauges": {"type": "array", "items": _VALUE_ENTRY},
        "histograms": {"type": "array", "items": _HIST_ENTRY},
    },
}

#: Schema an aggregated fleet snapshot must satisfy.
FLEET_SNAPSHOT_SCHEMA = {
    "type": "object",
    "required": ["schema", "growth_log", "processes", "counters", "gauges",
                 "histograms"],
    "properties": {
        "schema": {"type": "string"},
        "growth_log": {"type": "number"},
        "processes": {"type": "array", "items": {"type": "string"}},
        "counters": {"type": "array", "items": _VALUE_ENTRY},
        "gauges": {"type": "array", "items": _VALUE_ENTRY},
        "histograms": {"type": "array", "items": _HIST_ENTRY},
    },
}

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
}


def validate(obj, schema, path: str = "$") -> list:
    """Walk ``obj`` against a JSON-Schema subset; return error strings."""
    errors = []
    typ = schema.get("type")
    if typ is not None:
        pytype = _TYPES[typ]
        ok = isinstance(obj, pytype)
        if typ in ("integer", "number") and isinstance(obj, bool):
            ok = False  # bool is an int subclass; schemas mean real numbers
        if not ok:
            errors.append(f"{path}: expected {typ}, got "
                          f"{type(obj).__name__}")
            return errors
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in {schema['enum']}")
    if typ == "object":
        for key in schema.get("required", ()):
            if key not in obj:
                errors.append(f"{path}: missing required key {key!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in obj:
                errors.extend(validate(obj[key], sub, f"{path}.{key}"))
    elif typ == "array" and "items" in schema:
        for i, item in enumerate(obj):
            errors.extend(validate(item, schema["items"], f"{path}[{i}]"))
    return errors


def validate_trace(trace: dict) -> list:
    """Schema check + structural invariants; returns error strings."""
    errors = validate(trace, TRACE_SCHEMA)
    if errors:
        return errors
    spans = trace["spans"]
    tid = trace["trace_id"]
    if not spans:
        return [f"{tid}: trace has no spans"]
    ids = {s["span_id"] for s in spans}
    if len(ids) != len(spans):
        errors.append(f"{tid}: duplicate span_ids")
    roots = [s for s in spans if s["parent_id"] == -1]
    if len(roots) != 1:
        errors.append(f"{tid}: expected exactly one root span, "
                      f"got {len(roots)}")
    for s in spans:
        if s["parent_id"] != -1 and s["parent_id"] not in ids:
            errors.append(f"{tid}: span {s['span_id']} ({s['name']}) has "
                          f"dangling parent_id {s['parent_id']}")
        if s["t1"] < s["t0"]:
            errors.append(f"{tid}: span {s['span_id']} ({s['name']}) has "
                          f"t1 < t0")
        if s["parent_id"] != -1 and s.get("attrs", {}).get("dangling"):
            errors.append(f"{tid}: span {s['span_id']} ({s['name']}) was "
                          f"still open at trace finish (leaked span)")
    return errors


def validate_metrics_snapshot(snap: dict) -> list:
    """Schema check + structural invariants for a metrics snapshot.

    Accepts both wire forms — a per-process mergeable snapshot and an
    aggregated fleet snapshot (dispatched on the ``schema`` field) — and
    returns error strings.  Beyond the schema walk it verifies what a
    JSON schema can't: bucket indexes parse as integers, per-histogram
    bucket counts are positive and sum exactly to ``count``, and the
    min/max envelope is ordered.  ``check_traces.py`` runs this over CI
    exports; :mod:`repro_torch.obs.aggregate` runs it before merging so a
    corrupt snapshot fails loudly instead of skewing fleet percentiles.
    """
    from repro_torch.obs.aggregate import FLEET_SCHEMA_VERSION

    if not isinstance(snap, dict):
        return [f"$: expected object, got {type(snap).__name__}"]
    schema_id = snap.get("schema")
    if schema_id == SNAPSHOT_SCHEMA_VERSION:
        errors = validate(snap, METRICS_SNAPSHOT_SCHEMA)
    elif schema_id == FLEET_SCHEMA_VERSION:
        errors = validate(snap, FLEET_SNAPSHOT_SCHEMA)
    else:
        return [f"$.schema: unknown metrics snapshot schema {schema_id!r} "
                f"(expected {SNAPSHOT_SCHEMA_VERSION!r} or "
                f"{FLEET_SCHEMA_VERSION!r})"]
    if errors:
        return errors
    for i, e in enumerate(snap["histograms"]):
        where = f"$.histograms[{i}] ({e['name']})"
        total = 0
        for b, c in e["buckets"].items():
            try:
                int(b)
            except ValueError:
                errors.append(f"{where}: bucket index {b!r} is not an "
                              "integer")
                continue
            if not isinstance(c, int) or isinstance(c, bool) or c <= 0:
                errors.append(f"{where}: bucket {b} count {c!r} must be a "
                              "positive integer")
                continue
            total += c
        if total != e["count"]:
            errors.append(f"{where}: bucket counts sum to {total} but "
                          f"count={e['count']}")
        if e["count"] > 0:
            vmin, vmax = e.get("min"), e.get("max")
            if vmin is None or vmax is None:
                errors.append(f"{where}: non-empty histogram missing "
                              "min/max envelope")
            elif vmin > vmax:
                errors.append(f"{where}: min {vmin} > max {vmax}")
    return errors


def export_traces(tracer, path: str) -> int:
    """Write {"traces": [...]} to ``path``; returns the trace count."""
    traces = tracer.to_dicts()
    with open(path, "w") as f:
        json.dump({"traces": traces, "dropped": tracer.dropped}, f, indent=1)
    return len(traces)


def export_metrics(registry, path: str) -> None:
    """Write a MetricsRegistry snapshot to ``path``."""
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=1, sort_keys=True)


def export_mergeable_metrics(registry, path: str,
                             process: str = "0") -> dict:
    """Write one process's mergeable (fleet-combinable) snapshot.

    The document is validated before it hits disk — an unserializable or
    self-inconsistent snapshot fails at export time in the process that
    produced it, not later inside the aggregator with N files to bisect.
    """
    snap = registry.mergeable_snapshot(process=process)
    errors = validate_metrics_snapshot(snap)
    if errors:
        raise ValueError("refusing to export invalid metrics snapshot:\n"
                         + "\n".join(errors))
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    return snap


__all__ = ["TRACE_SCHEMA", "METRICS_SNAPSHOT_SCHEMA",
           "FLEET_SNAPSHOT_SCHEMA", "validate", "validate_trace",
           "validate_metrics_snapshot", "export_traces", "export_metrics",
           "export_mergeable_metrics"]
