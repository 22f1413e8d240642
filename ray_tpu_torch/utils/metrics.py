"""Metrics: Counter/Gauge/Histogram with a process-local registry.

Analogue of the reference's metrics stack (reference: src/ray/stats/
metric.cc + python/ray/util/metrics.py user-defined metrics; export via
the per-node agent to Prometheus). Here: components record into the
process registry; node agents push snapshots to the controller every
``metrics_report_period_ms``; the controller aggregates and renders a
Prometheus-style text exposition for scraping/CLI.

Locking: the module lock guards only the registry map (create/list);
every metric carries its own lock for value updates, so two components
recording different metrics never contend — the reference's stats layer
makes the same split between metric registration and recording.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._mlock = threading.Lock()
        with _lock:
            _registry[name] = self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        tags = tags or {}
        return tuple(tags.get(k, "") for k in self.tag_keys)

    def snapshot(self) -> List[Tuple[Tuple, float]]:
        with self._mlock:
            return list(self._values.items())


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        with self._mlock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._mlock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    """Fixed-boundary histogram (counts per bucket + sum/count)."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 100])
        self._buckets: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        k = self._key(tags)
        with self._mlock:
            b = self._buckets.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            # Bucket = count of boundaries strictly below value, i.e. the
            # first bucket whose upper bound (inclusive) admits it.
            b[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def snapshot(self):
        with self._mlock:
            return [(k, {"buckets": list(v),
                         "boundaries": list(self.boundaries),
                         "sum": self._sums.get(k, 0.0),
                         "count": self._counts.get(k, 0)})
                    for k, v in self._buckets.items()]


def snapshot_all() -> Dict[str, dict]:
    """Serializable registry snapshot (pushed to the controller)."""
    with _lock:
        metrics = list(_registry.values())
    return {m.name: {"kind": m.kind, "description": m.description,
                     "tag_keys": m.tag_keys, "values": m.snapshot()}
            for m in metrics}


def _escape_label(v) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote and newline must be escaped or the line is unparseable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v) -> str:
    """HELP text escaping (backslash and newline only, per the format)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(per_node: Dict[str, Dict[str, dict]]) -> str:
    """{node_hex: snapshot_all()} -> Prometheus text exposition."""
    lines: List[str] = []
    seen_help = set()
    for node, snap in sorted(per_node.items()):
        for name, m in sorted(snap.items()):
            if name not in seen_help:
                lines.append(f"# HELP {name} {_escape_help(m['description'])}")
                lines.append(f"# TYPE {name} {m['kind']}")
                seen_help.add(name)
            for tags_tuple, value in m["values"]:
                tag_parts = [f'node="{_escape_label(node)}"'] + [
                    f'{k}="{_escape_label(v)}"'
                    for k, v in zip(m["tag_keys"], tags_tuple)]
                tag_str = "{" + ",".join(tag_parts) + "}"
                if m["kind"] == "histogram":
                    bounds = value.get("boundaries") or []
                    cum = 0
                    for bi, count in enumerate(value["buckets"]):
                        cum += count
                        le = (f"{bounds[bi]}" if bi < len(bounds)
                              else "+Inf")
                        btags = tag_str[:-1] + f',le="{le}"}}'
                        lines.append(f"{name}_bucket{btags} {cum}")
                    lines.append(
                        f"{name}_sum{tag_str} {value['sum']}")
                    lines.append(
                        f"{name}_count{tag_str} {value['count']}")
                else:
                    lines.append(f"{name}{tag_str} {value}")
    return "\n".join(lines) + "\n"
