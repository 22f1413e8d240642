"""ray_tpu_torch.load — open-loop macro-load + chaos soak harness.

Analogue of the reference's external `release/` harness (reference:
release/release_tests.yaml nightly suites, incl. chaos_test.py
kill_random_node patterns), rebuilt in-repo and wired to the native
observability planes: the generator drives Serve + Data + Train
concurrently at fixed open-loop arrival rates while a declarative chaos
schedule kills workers and nodes, and the verdict engine turns the
planes (graftpulse, grafttrail, graftlog, graftscope) into machine-
checked SLO pass/fail rows (BENCH_LOAD.json).

    python -m ray_tpu_torch.cli soak --profile smoke|bench|full
    make bench-load
"""

from ray_tpu_torch.load.arrivals import SizeMix, generate_schedule
from ray_tpu_torch.load.scenario import (ChaosAction, SLOSpec, SoakSpec,
                                   WorkloadSpec, profile)
from ray_tpu_torch.load.soak import run_soak

__all__ = [
    "ChaosAction", "SLOSpec", "SizeMix", "SoakSpec", "WorkloadSpec",
    "generate_schedule", "profile", "run_soak",
]
