"""Declarative soak scenarios: workload rates, chaos schedule, SLOs.

A SoakSpec is the whole experiment as data (reference contrast: Ray's
release_tests.yaml names a cluster env + entrypoint script per test;
here the spec IS the test and the verdict engine reads the in-repo
observability planes instead of external Grafana/S3 artifacts).

Profiles:
    smoke — ~8s, 2 nodes, tiny rates, one worker kill. Runs in tier-1
            CI: the point is that every PR exercises the whole
            load->chaos->planes->verdict loop, not peak throughput.
    bench — ~20s, 3 nodes, moderate rates, worker kill + node kill +
            replacement node. `make bench-load` (BENCH_LOAD.json).
    full  — ~45s, 3 nodes, higher rates, two chaos rounds. Marked slow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ray_tpu_torch.load.arrivals import SizeMix


@dataclass
class ChaosAction:
    """One scheduled fault, offset seconds from load start."""
    at_s: float
    kind: str              # kill_worker | kill_node | add_node
    note: str = ""


@dataclass
class WorkloadSpec:
    kind: str              # serve | data | train
    rate_hz: float
    mix: SizeMix = SizeMix()
    timeout_s: float = 30.0
    waiters: int = 4


@dataclass
class SLOSpec:
    """Machine-checked budgets the verdict engine asserts from the
    planes. Generous by design for CI boxes — the check is that the
    loop holds under chaos, not that a laptop hits prod latencies."""
    pulse_p99_ms: float = 250.0      # worst native-op p99, pulse window
    pulse_window: int = 50           # pulses per node in the aggregate
    workload_p99_ms: float = 5000.0  # per-workload open-loop p99
    min_completion_frac: float = 0.70
    max_error_frac: float = 0.30
    recovery_s: float = 15.0         # kill -> detected/salvaged budget


@dataclass
class SoakSpec:
    name: str
    duration_s: float
    nodes: int = 2
    node_cpus: float = 4.0
    seed: int = 20260805
    workloads: List[WorkloadSpec] = field(default_factory=list)
    chaos: List[ChaosAction] = field(default_factory=list)
    slo: SLOSpec = field(default_factory=SLOSpec)
    settle_s: float = 20.0           # post-load drain/audit deadline
    # Fast-detection pulse config so a kill surfaces inside the run
    # (mirrors tests/test_graftpulse.py's pulse_cluster fixture).
    # log_to_driver off: BENCH_LOAD.json rows stream on stdout and the
    # worker lines still land in graftlog — the soak reads them there.
    config_overrides: dict = field(default_factory=lambda: {
        "pulse_period_ms": 200, "pulse_dead_ms": 2500,
        "health_check_period_ms": 100, "log_to_driver": False})


def smoke(duration_s: float = 8.0, seed: int = 20260805) -> SoakSpec:
    return SoakSpec(
        name="smoke", duration_s=duration_s, nodes=2, seed=seed,
        workloads=[
            WorkloadSpec("serve", rate_hz=8.0,
                         mix=SizeMix(base=512, cap=1 << 14)),
            WorkloadSpec("data", rate_hz=4.0,
                         mix=SizeMix(base=2048, cap=1 << 16)),
            WorkloadSpec("train", rate_hz=2.0,
                         mix=SizeMix(base=64, heavy_frac=0.0),
                         waiters=1),  # steps serialise on the actor
        ],
        chaos=[ChaosAction(at_s=duration_s * 0.4, kind="kill_worker")],
        settle_s=25.0)


def bench(duration_s: float = 20.0, seed: int = 20260805) -> SoakSpec:
    return SoakSpec(
        name="bench", duration_s=duration_s, nodes=3, seed=seed,
        workloads=[
            WorkloadSpec("serve", rate_hz=20.0,
                         mix=SizeMix(base=1024, cap=1 << 16)),
            WorkloadSpec("data", rate_hz=10.0,
                         mix=SizeMix(base=4096, cap=1 << 18)),
            WorkloadSpec("train", rate_hz=3.0,
                         mix=SizeMix(base=64, heavy_frac=0.0),
                         waiters=1),
        ],
        chaos=[
            ChaosAction(at_s=duration_s * 0.3, kind="kill_worker"),
            ChaosAction(at_s=duration_s * 0.5, kind="kill_node"),
            ChaosAction(at_s=duration_s * 0.6, kind="add_node",
                        note="replacement capacity"),
        ],
        settle_s=30.0)


def full(duration_s: float = 45.0, seed: int = 20260805) -> SoakSpec:
    spec = bench(duration_s=duration_s, seed=seed)
    spec.name = "full"
    spec.workloads[0].rate_hz = 30.0
    spec.workloads[1].rate_hz = 15.0
    spec.chaos = [
        ChaosAction(at_s=duration_s * 0.25, kind="kill_worker"),
        ChaosAction(at_s=duration_s * 0.45, kind="kill_node"),
        ChaosAction(at_s=duration_s * 0.55, kind="add_node",
                    note="replacement capacity"),
        ChaosAction(at_s=duration_s * 0.75, kind="kill_worker"),
    ]
    spec.settle_s = 45.0
    return spec


_PROFILES = {"smoke": smoke, "bench": bench, "full": full}


def profile(name: str, duration_s: Optional[float] = None,
            seed: Optional[int] = None) -> SoakSpec:
    kw = {}
    if duration_s is not None:
        kw["duration_s"] = duration_s
    if seed is not None:
        kw["seed"] = seed
    return _PROFILES[name](**kw)
