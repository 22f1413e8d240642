"""Route table shared by the ingress proxies (HTTP + gRPC).

Analogue of the reference's proxy route resolution (reference:
serve/_private/proxy.py — both ingress flavors resolve route prefixes to
deployment handles off one controller-fed table)."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle


class RouteTable:
    """route_prefix -> deployment resolution + handle cache. Refreshes
    are rate-limited (negative cache) so unknown-path probes can't
    hammer the controller.

    Shared across the HTTP proxy's and gRPC proxy's thread pools: the
    refresh claim and the handle cache are lock-guarded (the routes dict
    itself is replaced atomically, so match() reads lock-free)."""

    _NEG_CACHE_TTL_S = 2.0

    def __init__(self, controller_handle):
        self._controller = controller_handle
        self._routes: Dict[str, str] = {}
        self._handles: Dict[str, DeploymentHandle] = {}
        self._last_refresh = 0.0
        self._lock = threading.Lock()

    @property
    def routes(self) -> Dict[str, str]:
        return self._routes

    def refresh(self) -> None:
        """Blocking controller RPC — call OFF any serving event loop."""
        table = ray_tpu_torch.get(self._controller.list_deployments.remote(),
                            timeout=10)
        # Build fully, assign once (readers see either table, never a
        # half-cleared one).
        routes = {}
        for name, info in table.items():
            prefix = info["config"].get("route_prefix") or f"/{name}"
            routes[prefix] = name
        self._routes = routes

    def match(self, path: str) -> Optional[str]:
        """Longest-prefix route match -> deployment name (no refresh)."""
        routes = self._routes  # snapshot: refresh() swaps the dict
        best = max((p for p in routes
                    if path == p or path.startswith(p + "/")),
                   key=len, default=None)
        return routes[best] if best is not None else None

    def should_refresh(self) -> bool:
        """Atomically claim the next refresh window (at most one caller
        per TTL gets True)."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_refresh > self._NEG_CACHE_TTL_S:
                self._last_refresh = now
                return True
            return False

    def handle_for(self, deployment: str) -> DeploymentHandle:
        with self._lock:
            h = self._handles.get(deployment)
            if h is None:
                h = self._handles[deployment] = DeploymentHandle(
                    deployment, self._controller)
            return h
