"""graftscale: the thousand-node scale harness.

Multiplexes hundreds of lightweight simulated node agents onto one
host process — real graftrpc connections, real graftpulse wire frames,
real trail/log/prof batches from seeded deterministic workload models,
no workers — and ramps the population against a real controller
subprocess until a machine-checked limit trips. The controller's own
graftmeta plane is the instrument: per-plane ingest rates, fold-latency
percentiles, event-loop lag and RSS all come from the system under
test metering itself (``meta_snapshot``), not from an external probe.

``harness.run_scale(ScaleSpec(...))`` emits graftload-style JSONL rows
(level rows + verdict rows + a meta row); ``bench_scale.py`` at the
repo root wraps it as `make bench-scale` -> BENCH_SCALE.json.
"""

from ray_tpu_torch.scale.harness import ScaleSpec, run_scale  # noqa: F401
from ray_tpu_torch.scale.simnode import SimHost, SimNode  # noqa: F401
