"""graftmeta: the plane that watches the planes.

Every observability plane (pulse/trail/prof/log/scope/sched/metrics)
folds into the one controller asyncio loop — the same topology as Ray's
GCS, whose failure mode at cardinality is well documented: the
singleton aggregator saturates silently and the first symptom is nodes
being declared dead because their perfectly healthy heartbeats queued
behind someone else's log storm. We built planes that can see
everything *except themselves*; graftmeta closes that loop.

The controller self-meters each plane's ingest path: cumulative
records/bytes/batches/drops plus a log2 fold-latency histogram (same
bucket geometry as graftpulse, so `percentile_ns` and the rendering
code are shared), event-loop lag sampled by the meta tick's own sleep
overshoot, and controller RSS per tick — all in a bounded ring of tick
snapshots so rates and percentiles are computed over a *window* by
differencing two snapshots, never by per-record timestamping (the meter
must cost strictly less than what it measures).

Single-threaded by construction: every mutating call happens on the
controller's asyncio loop (ingest handlers and the meta tick both run
there), so there are no locks to contend and a `note()` is a handful of
integer adds. Surfaced at ``/api/meta``, ``/metrics/cluster``
(raytpu_meta_* gauges) and ``ray_tpu status --planes``; folds slower
than ``meta_span_min_us`` additionally emit controller-side
``meta.fold.<plane>`` spans into the native timeline so
``timeline --native`` shows where a pulse tick's milliseconds go.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core._native.graftpulse import (PULSE_HIST_BUCKETS,
                                                   PULSE_HIST_SHIFT,
                                                   percentile_ns)

# Every ingest seam the controller owns, in display order. "pulse",
# "trail", "prof" and "log" are the four stores; "scope" is the native
# span sink, "sched" the fire-and-forget scheduling deltas, "metrics"
# the legacy per-node metrics dict.
PLANES = ("pulse", "trail", "prof", "log", "scope", "sched", "metrics")

_HB = PULSE_HIST_BUCKETS


def enabled() -> bool:
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        return bool(GlobalConfig.graftmeta)
    except Exception:
        return True


def _bucket(dur_ns: int) -> int:
    """log2 bucket index for a fold duration, clamped into the shared
    pulse geometry: bucket b covers [2^(SHIFT+b), 2^(SHIFT+b+1))."""
    if dur_ns <= 0:
        return 0
    return min(_HB - 1, max(0, dur_ns.bit_length() - 1 - PULSE_HIST_SHIFT))


class _PlaneMeter:
    """Cumulative counters for one plane. Plain attributes, no lock —
    loop-owned (see module docstring)."""

    __slots__ = ("records", "bytes", "batches", "drops", "fold_ns",
                 "hist")

    def __init__(self) -> None:
        self.records = 0
        self.bytes = 0
        self.batches = 0
        self.drops = 0
        self.fold_ns = 0
        self.hist = [0] * _HB

    def snap(self) -> Tuple[int, int, int, int, int, Tuple[int, ...]]:
        return (self.records, self.bytes, self.batches, self.drops,
                self.fold_ns, tuple(self.hist))


class MetaPlane:
    """The controller's self-telemetry: per-plane meters + a bounded
    ring of tick snapshots for windowed rates."""

    def __init__(self, history: int = 600):
        self.meters: Dict[str, _PlaneMeter] = {p: _PlaneMeter()
                                               for p in PLANES}
        self.lag_hist = [0] * _HB
        self.lag_max_ns = 0
        self.lag_samples = 0
        # tick ring: (t_mono, rss_bytes, lag_hist_tuple, lag_max_ns,
        #             {plane: meter.snap()})
        self.ticks: deque = deque(maxlen=max(2, int(history)))
        self.t0_mono = time.monotonic()

    # --- mutation (loop thread only) ----------------------------------

    def note(self, plane: str, records: int, nbytes: int,
             dur_ns: int) -> None:
        """One ingest batch folded: how much arrived and how long the
        fold held the event loop."""
        m = self.meters[plane]
        m.records += records
        m.bytes += nbytes
        m.batches += 1
        m.fold_ns += dur_ns
        m.hist[_bucket(dur_ns)] += 1

    def drop(self, plane: str, records: int = 1) -> None:
        """A batch (or frame) arrived malformed / rate-limited away."""
        self.meters[plane].drops += records

    def loop_lag(self, lag_ns: int) -> None:
        """Event-loop lag probe: the meta tick's asyncio.sleep overshoot
        — everything that ran on the loop between two ticks shows up
        here, which is exactly the number that predicts heartbeat
        starvation."""
        if lag_ns < 0:
            lag_ns = 0
        self.lag_hist[_bucket(lag_ns)] += 1
        self.lag_max_ns = max(self.lag_max_ns, lag_ns)
        self.lag_samples += 1

    def tick(self, rss_bytes: int) -> None:
        """Snapshot all cumulative meters into the ring (one call per
        meta_tick_ms, from the controller's meta loop)."""
        self.ticks.append((time.monotonic(), rss_bytes,
                           tuple(self.lag_hist), self.lag_max_ns,
                           {p: m.snap() for p, m in self.meters.items()}))

    # --- queries ------------------------------------------------------

    def _window_base(self, window: int):
        """The oldest retained tick inside the last `window` ticks, or
        None before the first tick lands."""
        if not self.ticks:
            return None
        n = len(self.ticks)
        idx = max(0, n - max(1, int(window)))
        return self.ticks[idx]

    def snapshot(self, window: int = 60,
                 stores: Optional[dict] = None) -> dict:
        """Everything /api/meta serves: per-plane cumulative counters,
        windowed records/s + bytes/s, windowed fold p50/p99, loop lag,
        RSS trajectory over the window, plus whatever store-occupancy
        dicts the controller hands in (the MetaPlane stays ignorant of
        store internals)."""
        now = time.monotonic()
        base = self._window_base(window)
        span_s = (now - base[0]) if base else 0.0
        planes: Dict[str, dict] = {}
        for p in PLANES:
            m = self.meters[p]
            row = {"records": m.records, "bytes": m.bytes,
                   "batches": m.batches, "drops": m.drops,
                   "fold_ms_total": round(m.fold_ns / 1e6, 3)}
            if base and span_s > 0:
                b = base[4].get(p)
                brec, bbytes, bbatch, bdrops, bfold, bhist = (
                    b if b else (0, 0, 0, 0, 0, (0,) * _HB))
                row["records_per_s"] = round((m.records - brec) / span_s,
                                             2)
                row["bytes_per_s"] = round((m.bytes - bbytes) / span_s, 2)
                row["batches_per_s"] = round((m.batches - bbatch) /
                                             span_s, 2)
                dh = [a - c for a, c in zip(m.hist, bhist)]
            else:
                row["records_per_s"] = 0.0
                row["bytes_per_s"] = 0.0
                row["batches_per_s"] = 0.0
                dh = m.hist
            row["fold_p50_ns"] = percentile_ns(dh, 0.50)
            row["fold_p99_ns"] = percentile_ns(dh, 0.99)
            planes[p] = row
        if base:
            lag_dh = [a - c for a, c in zip(self.lag_hist, base[2])]
        else:
            lag_dh = self.lag_hist
        rss_now = self.ticks[-1][1] if self.ticks else 0
        out = {
            "t_wall_ns": time.time_ns(),
            "uptime_s": round(now - self.t0_mono, 3),
            "window_s": round(span_s, 3),
            "ticks": len(self.ticks),
            "rss_bytes": rss_now,
            "rss_window_first_bytes": base[1] if base else 0,
            "loop_lag": {
                "p50_ns": percentile_ns(lag_dh, 0.50),
                "p99_ns": percentile_ns(lag_dh, 0.99),
                "max_ns": self.lag_max_ns,
                "samples": self.lag_samples,
            },
            "planes": planes,
        }
        if stores is not None:
            out["stores"] = stores
        return out

    def rss_series(self) -> List[Tuple[float, int]]:
        """(age_s, rss_bytes) per retained tick, oldest first — what the
        scale harness reads to judge RSS growth per node level."""
        now = time.monotonic()
        return [(round(now - t, 3), rss) for t, rss, _h, _m, _s
                in self.ticks]
