"""Exporters: one snapshot schema, three wire forms.

Ports paddle_tpu/monitor/exporters.py unchanged (pure Python), so that
the two packages' text forms are byte for byte the same and one scraper
reads both:

- ``to_json(snap)`` — the snapshot dict as JSON;
- ``to_prometheus(snap)`` — Prometheus text exposition 0.0.4 of the SAME
  snapshot (``parse_prometheus`` inverts it);
- JSONL structured event log — ``log_event(kind, **fields)`` appends one
  ``{"ts", "event", ...}`` line to ``FLAGS_monitor_log_path`` (unset =
  disabled). ``log_snapshot()`` writes the whole snapshot as one event.
"""
import json
import re
import threading
import time

__all__ = ["to_json", "to_prometheus", "parse_prometheus", "flatten",
           "log_event", "log_snapshot"]

_LOG_LOCK = threading.Lock()


def _label_str(labels):
    if not labels:
        return ""
    esc = {k: str(v).replace("\\", r"\\").replace('"', r'\"')
           .replace("\n", r"\n") for k, v in labels.items()}
    return "{" + ",".join(f'{k}="{esc[k]}"' for k in sorted(esc)) + "}"


def _num(v):
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def to_json(snap, indent=None):
    return json.dumps(snap, indent=indent, sort_keys=True)


#: histogram summary() percentile -> prometheus quantile label value
_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99"))


def to_prometheus(snap, summaries=None):
    """Prometheus text exposition of a registry snapshot.

    ``summaries`` (optional) is a ``{'name{k=v,...}': {'p50': ...,
    'p90': ..., 'p99': ...}}`` digest of the registry histograms'
    ``summary()`` — given, each histogram series additionally emits
    standard ``name{...,quantile="0.5"} v`` samples, so the percentile
    digest survives the text form and :func:`parse_prometheus`
    round-trips it. Default (None) output is the plain form."""
    lines = []
    for m in snap["metrics"]:
        name = m["name"].replace("-", "_").replace(".", "_")
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['type']}")
        for s in m["series"]:
            if m["type"] in ("counter", "gauge"):
                lines.append(
                    f"{name}{_label_str(s['labels'])} {_num(s['value'])}")
            else:  # histogram
                for le, cum in s["buckets"]:
                    lb = dict(s["labels"])
                    lb["le"] = le if le == "+Inf" else _num(le)
                    lines.append(f"{name}_bucket{_label_str(lb)} {cum}")
                base = _label_str(s["labels"])
                lines.append(f"{name}_sum{base} {_num(s['sum'])}")
                lines.append(f"{name}_count{base} {s['count']}")
                if summaries:
                    lb0 = s["labels"]
                    key = m["name"] + ("" if not lb0 else "{" + ",".join(
                        f"{k}={lb0[k]}" for k in sorted(lb0)) + "}")
                    summ = summaries.get(key) or {}
                    for pct, q in _QUANTILES:
                        if summ.get(pct) is None:
                            continue
                        lb = dict(lb0)
                        lb["quantile"] = q
                        lines.append(
                            f"{name}{_label_str(lb)} {_num(summ[pct])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text, skipped=None):
    """Invert to_prometheus: {(sample_name, frozenset(labels)): value}.
    Covers exactly the subset to_prometheus emits — including the
    ``quantile=``-labelled summary samples the ``summaries=`` form adds
    (no exemplars/escapes beyond its own) — the exporter round-trip
    contract, not a general prometheus parser.

    A non-comment line that is not a valid sample (e.g. a human-format
    ``name{...}: {json}`` percentile digest from an older metrics dump)
    is SKIPPED instead of raising; pass a list as ``skipped`` to collect
    ``(line, reason)`` pairs — explicit skip-with-reason rather than a
    silent drop or a ValueError crash mid-parse."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, _, val = line.rpartition(" ")
        try:
            value = float("inf") if val == "+Inf" else float(val)
        except ValueError:
            if skipped is not None:
                skipped.append((line, f"sample value {val!r} is not a "
                                      "float — not exposition format"))
            continue
        if "{" in body:
            name, _, rest = body.partition("{")
            rest = rest.rstrip("}")
            labels = {}
            for part in _split_labels(rest):
                k, _, v = part.partition("=")
                if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                    v = v[1:-1]   # exactly one quote per side: .strip('"')
                    # would also eat a trailing ESCAPED quote's char
                # single-pass unescape: sequential .replace would decode
                # an escaped backslash followed by 'n' as a newline
                labels[k] = re.sub(
                    r"\\(.)",
                    lambda mt: {"n": "\n"}.get(mt.group(1), mt.group(1)), v)
        else:
            name, labels = body, {}
        out[(name, frozenset(labels.items()))] = value
    return out


def _split_labels(s):
    """Split 'a="x",b="y,z"' on commas outside quotes."""
    parts, cur, inq, prev = [], [], False, ""
    for ch in s:
        if ch == '"' and prev != "\\":
            inq = not inq
        if ch == "," and not inq:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p]


def flatten(snap):
    """Compact one-level view: 'name{k=v,...}' -> value (counters/gauges)
    or {'count', 'sum'} (histograms) — small enough for a log line,
    still attributable."""
    out = {}
    for m in snap["metrics"]:
        for s in m["series"]:
            lb = s["labels"]
            key = m["name"] + ("" if not lb else
                               "{" + ",".join(f"{k}={lb[k]}"
                                              for k in sorted(lb)) + "}")
            if m["type"] == "histogram":
                out[key] = {"count": s["count"], "sum": round(s["sum"], 3)}
            else:
                out[key] = s["value"]
    return out


def _log_path():
    from .. import flags as _flags

    return _flags.get_flag("monitor_log_path", "") or None


def log_event(event, _path=None, **fields):
    """Append one structured event line to the JSONL log. Returns the
    record, or None when logging is off (no path configured)."""
    path = _path or _log_path()
    if not path:
        return None
    rec = {"ts": round(time.time(), 6), "event": str(event)}
    rec.update(fields)
    line = json.dumps(rec, sort_keys=True)
    with _LOG_LOCK:
        with open(path, "a") as f:
            f.write(line + "\n")
    return rec


def log_snapshot(snap, _path=None, **fields):
    """Write a full registry snapshot as one 'snapshot' event."""
    return log_event("snapshot", _path=_path, snapshot=snap, **fields)
