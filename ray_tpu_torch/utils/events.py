"""Structured event export — lifecycle events to a JSONL sink.

Analogue of the reference's export-API pipeline (reference:
src/ray/observability/ray_event_recorder.cc structured lifecycle events +
dashboard/modules/aggregator/aggregator_agent.py shipping export_*.proto
events to external sinks). Slimmed to the durable core: every control-
plane event (node/actor/job/serve lifecycle via the pubsub hub, plus
task state transitions) appends as one JSON line to
``event_export_path`` — the integration seam log shippers tail.

Every event carries both clocks: ``ts`` (wall, for humans and log
shippers) and ``mono_ns`` (CLOCK_MONOTONIC, the clock graftpulse ticks
and graftscope records use) so events and pulses merge onto one
timeline without wall-clock skew artifacts.

The buffer is bounded (``event_buffer_max``): when a sink stalls or the
path is unwritable, the oldest unflushed events are dropped rather than
growing without bound, and the drop count is exposed both as a module
total (``dropped_total`` — stamped into each node's pulse) and as the
``raytpu_events_dropped`` gauge.

Enable with RAY_TPU_TORCH_EVENT_EXPORT_PATH=/path/events.jsonl (or the
event_export_path config flag).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

# Events dropped across every exporter in this process (drop-oldest on
# buffer overflow + lines lost to sink write failures).
_dropped = 0
_dropped_lock = threading.Lock()
_dropped_gauge = None


def dropped_total() -> int:
    """Process-wide count of events lost to buffer bounds or sink
    failures (rides in the node pulse as ``events_dropped``)."""
    return _dropped


def _count_dropped(n: int) -> None:
    global _dropped, _dropped_gauge
    if n <= 0:
        return
    with _dropped_lock:
        _dropped += n
        try:
            if _dropped_gauge is None:
                from ray_tpu_torch.utils import metrics as M
                _dropped_gauge = M.Gauge(
                    "raytpu_events_dropped",
                    "Lifecycle events lost to the bounded export buffer "
                    "or sink write failures.")
            _dropped_gauge.set(_dropped)
        except Exception:
            pass  # metrics are best-effort here too


class EventExporter:
    """Buffered JSONL appender (thread-safe; best-effort — an export
    failure must never take down the control plane, and a stalled sink
    must never grow the buffer without bound)."""

    _FLUSH_EVERY = 64

    def __init__(self, path: str, max_buffered: Optional[int] = None):
        self._path = path
        self._lock = threading.Lock()
        self._buf: list = []
        if max_buffered is None:
            try:
                from ray_tpu_torch.utils.config import GlobalConfig
                max_buffered = int(GlobalConfig.event_buffer_max)
            except Exception:
                max_buffered = 4096
        self._max = max(1, max_buffered)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # Interpreter exit must not strand a partial batch in the buffer
        # (events below _FLUSH_EVERY would otherwise never hit the sink).
        import atexit
        atexit.register(self.flush)

    def emit(self, source: str, event: Any) -> None:
        rec = {"ts": time.time(), "mono_ns": time.monotonic_ns(),
               "source": source, "event": _jsonable(event)}
        overflow = 0
        with self._lock:
            self._buf.append(json.dumps(rec))
            if len(self._buf) > self._max:
                # Drop-oldest: the newest events are the ones a post-
                # mortem needs most.
                overflow = len(self._buf) - self._max
                del self._buf[:overflow]
            if len(self._buf) >= min(self._FLUSH_EVERY, self._max):
                self._flush_locked()
        if overflow:
            _count_dropped(overflow)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        lines, self._buf = self._buf, []
        try:
            with open(self._path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            # best-effort: never fail the control plane — but do count
            # what the sink lost.
            _count_dropped(len(lines))


def _jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        return {str(_jsonable(k)): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def exporter_from_config() -> Optional[EventExporter]:
    from ray_tpu_torch.utils.config import GlobalConfig
    path = GlobalConfig.event_export_path
    return EventExporter(path) if path else None
