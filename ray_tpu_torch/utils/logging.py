"""Structured per-process logging (analogue of reference src/ray/util logging +
python/ray/_private/ray_logging). Each process logs to stderr and, when a
session directory is configured, to ``<session>/logs/<component>-<pid>.log``
(size-capped and rotated — see ``log_file_max_bytes``/``log_file_backups``).

Every ``ray_tpu.*`` record is also routed into the graftlog plane with its
level preserved: the handler appends to this process's crash-persistent
ring (or its pending buffer before the ring opens), so logger output is
queryable cluster-wide and survives a SIGKILL for postmortem salvage.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(process)d %(name)s] %(message)s"
_configured = False
_graftlog_attached = False
_file_handlers: set[str] = set()


def _file_limits() -> tuple[int, int]:
    try:
        from ray_tpu_torch.utils.config import GlobalConfig
        return (int(GlobalConfig.log_file_max_bytes),
                int(GlobalConfig.log_file_backups))
    except Exception:
        return 16 << 20, 3


def configure(component: str = "driver", session_dir: str | None = None,
              level: int = logging.INFO) -> logging.Logger:
    global _configured, _graftlog_attached
    root = logging.getLogger("ray_tpu_torch")
    if not _configured:
        root.setLevel(level)
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(h)
        root.propagate = False
        _configured = True
    if not _graftlog_attached:
        try:
            from ray_tpu_torch.core._native import graftlog
            if graftlog.enabled():
                root.addHandler(graftlog.GraftlogHandler())
            _graftlog_attached = True
        except Exception:
            pass
    if session_dir:
        log_dir = os.path.join(session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{component}-{os.getpid()}.log")
        if path not in _file_handlers:  # one handler per file, ever
            _file_handlers.add(path)
            max_bytes, backups = _file_limits()
            if max_bytes > 0:
                fh: logging.Handler = logging.handlers.RotatingFileHandler(
                    path, maxBytes=max_bytes, backupCount=backups)
            else:
                fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(fh)
    return root


def get_logger(name: str) -> logging.Logger:
    configure()
    return logging.getLogger(f"ray_tpu_torch.{name}")
