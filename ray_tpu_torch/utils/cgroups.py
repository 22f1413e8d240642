"""Worker resource isolation — cgroup v2 slices with an rlimit fallback.

Analogue of the reference's cgroup layer (reference: src/ray/common/
cgroup2/ — system vs worker cgroup slices with memory/cpu limits).
TPU-host reality: clusters run workers as root on dedicated VMs (cgroup
v2 writable) OR inside containers where only rlimits apply — so this is
a two-tier seam:

  1. cgroup v2 (preferred): a `raytpu-workers/<name>` subtree per
     dedicated worker with memory.max / cpu.max from the actor's
     resource request; removed when the worker exits.
  2. RLIMIT_DATA fallback (opt-in via worker_rlimit_memory): caps the
     worker's heap at spawn — a hard per-process backstop under the
     node-level memory-monitor OOM policy.

Isolation applies to DEDICATED actor workers only: pooled task workers
are reused across requests with different shapes, so a per-process
limit would outlive the request that asked for it.
"""

from __future__ import annotations

import os
import resource
from typing import Optional

from ray_tpu_torch.utils import get_logger

logger = get_logger("cgroups")

CGROUP_ROOT = "/sys/fs/cgroup"
_SUBTREE = "raytpu-workers"


def _v2_available(root: str = CGROUP_ROOT) -> bool:
    """cgroup v2 unified hierarchy, writable by this process."""
    ctrl = os.path.join(root, "cgroup.controllers")
    return os.path.exists(ctrl) and os.access(root, os.W_OK)


class WorkerCgroup:
    """One worker's cgroup scope (no-op object when v2 is unavailable)."""

    def __init__(self, path: Optional[str]):
        self._path = path

    @property
    def active(self) -> bool:
        return self._path is not None

    def add_pid(self, pid: int) -> None:
        if self._path is None:
            return
        try:
            with open(os.path.join(self._path, "cgroup.procs"), "w") as f:
                f.write(str(pid))
        except OSError as e:
            logger.warning("could not move pid %d into %s: %r", pid,
                           self._path, e)

    def cleanup(self) -> None:
        if self._path is None:
            return
        try:
            os.rmdir(self._path)  # cgroup dirs remove via rmdir
        except OSError:
            pass
        self._path = None


def create_worker_cgroup(name: str, *,
                         memory_bytes: Optional[int] = None,
                         cpus: Optional[float] = None,
                         root: str = CGROUP_ROOT) -> WorkerCgroup:
    """Create a limited scope for one worker; returns an inactive scope
    when cgroup v2 isn't available/writable (callers fall back to
    rlimits / the memory monitor)."""
    if not _v2_available(root):
        return WorkerCgroup(None)
    try:
        base = os.path.join(root, _SUBTREE)
        os.makedirs(base, exist_ok=True)
        # Delegate the controllers down BOTH levels: enabling them only
        # at the root surfaces memory.max/cpu.max in raytpu-workers but
        # NOT in its children — the leaf writes below would ENOENT.
        for level in (root, base):
            try:
                with open(os.path.join(level, "cgroup.subtree_control"),
                          "w") as f:
                    f.write("+memory +cpu")
            except OSError:
                pass  # may already be enabled / partially available
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        if memory_bytes:
            with open(os.path.join(path, "memory.max"), "w") as f:
                f.write(str(int(memory_bytes)))
        if cpus:
            # cpu.max: "<quota> <period>" microseconds.
            period = 100_000
            with open(os.path.join(path, "cpu.max"), "w") as f:
                f.write(f"{int(cpus * period)} {period}")
        return WorkerCgroup(path)
    except OSError as e:
        logger.warning("cgroup isolation unavailable (%r); relying on "
                       "the memory-monitor OOM policy", e)
        return WorkerCgroup(None)


def rlimit_preexec(memory_bytes: int):
    """preexec_fn capping the child's heap (RLIMIT_DATA covers brk +
    data mmaps on Linux >= 4.7). Runs in the forked child, pre-exec —
    `resource` is imported at module level and captured here because an
    import inside the fork of a multithreaded parent can deadlock on
    the inherited import lock."""
    setrlimit = resource.setrlimit
    limit = resource.RLIMIT_DATA

    def apply():
        setrlimit(limit, (memory_bytes, memory_bytes))

    return apply
