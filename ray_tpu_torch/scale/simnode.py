"""Simulated node agents: the multiplexing layer of graftscale.

One ``SimNode`` is the control-plane ghost of a node agent: it holds a
real ``RpcClient`` connection to the controller, registers with a real
node id, heartbeats, and ships one wire-true graftpulse frame plus
trail/log/prof batches per tick — all synthesized from a seeded
deterministic workload model instead of real workers. Hundreds of them
share one asyncio loop and one ``SimHost`` RpcServer that answers the
few agent-side RPCs the controller initiates (``trail_residents`` for
the conservation audit, ``reconcile_bundles``), so from the
controller's side the cluster is indistinguishable from N live agents
— every ingest path, fold, cadence FSM and store sees production
traffic shapes at populations no real deployment of this repo has.

Determinism: every stochastic choice draws from
``random.Random(seed * 1000003 + index)``, so a (seed, index) pair
replays the same pulse kinds, task lifecycles and log cadence run
after run — a failing scale level is re-runnable.

Kill semantics: ``kill()`` silences the node mid-flight (open tasks
stay open, live objects stay "resident" only in the ledger) — the
controller must detect the pulse silence, fold node-death provenance
into the trail, and keep the audit clean. ``stop()`` is the graceful
path: open work is finished in a final batch first.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import struct
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core._native import graftpulse, graftscope
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.rpc import RpcClient, RpcServer
from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.aio import spawn

logger = get_logger("graftscale")

# The op mix one sim node reports per pulse: a plausible small slice of
# the real kind table (client-side send/flush + sidecar service ops).
_PULSE_KINDS = ("rpc_send", "rpc_recv", "rpc_flush", "sc_begin", "sc_end")

_TASK_NAMES = ("sim_ingest", "sim_transform", "sim_reduce")


class SimNode:
    """One multiplexed node agent (see module docstring)."""

    def __init__(self, index: int, seed: int,
                 controller_addr: Tuple[str, int],
                 sim_addr: Tuple[str, int],
                 tick_s: float = 1.0,
                 wire_version: int = graftpulse.PULSE_VERSION):
        self.index = index
        self.rng = random.Random(seed * 1000003 + index)
        # NOT NodeID.random(): that id's first 8 bytes are a per-
        # PROCESS prefix, so every sim node in one host process would
        # share the hex12 prefix the controller keys its per-node
        # plane state on — N nodes would collapse into one series.
        # A (seed, index) digest is unique AND replayable.
        self.node_id = NodeID(hashlib.blake2b(
            b"graftscale:%d:%d" % (seed, index),
            digest_size=NodeID.SIZE).digest())
        self.hex12 = self.node_id.binary().hex()[:12]
        self.controller_addr = controller_addr
        self.sim_addr = sim_addr
        self.tick_s = tick_s
        self.wire_version = wire_version
        self.client = RpcClient(controller_addr, max_retries=2,
                                timeout=15.0)
        # workload-model state
        self._seq = 0
        self._tick = 0
        self._task_seq = 0
        self._obj_seq = 0
        self._log_seq = 0
        # task_id -> finish-at tick (tasks held open across ticks)
        self._open_tasks: Dict[str, int] = {}
        self._live_oids: List[str] = []
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self.killed = False
        self.registered = False
        # Lifetime bounds (monotonic): the harness integrates these
        # into node-seconds, the denominator of the RSS-growth verdict.
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        # per-plane sent counters, for the harness's own bookkeeping
        self.sent = {"pulse": 0, "trail": 0, "log": 0, "prof": 0}

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        await self.client.call(
            "register_node", self.node_id.binary(), self.sim_addr,
            {"CPU": 4.0, "memory": float(2 << 30)},
            {"sim": "1", "sim_index": str(self.index)})
        self.registered = True
        self.t_start = time.monotonic()
        self._task = spawn(self._loop())

    async def stop(self) -> None:
        """Graceful: finish open work in one last batch, then go quiet."""
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        if not self.killed:
            try:
                await self.client.call("report_trail_batch",
                                       self.node_id.binary(),
                                       self._drain_events(), [])
            except Exception:
                pass
        await self.client.close()

    def kill(self) -> None:
        """SIGKILL analogue: stop mid-flight, leaving open tasks and
        "resident" objects for the controller's node-death fold."""
        self.killed = True
        self._stopped = True
        self.t_end = time.monotonic()
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _drain_events(self) -> list:
        ts = time.time()
        out = [(tid, 0, "FINISHED", ts, {"node": self.hex12})
               for tid in self._open_tasks]
        self._open_tasks.clear()
        return out

    # -- tick loop ---------------------------------------------------------

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        # Staggered phase: N nodes must not fire in lockstep — the real
        # fleet never does, and the herd would measure the harness.
        start = loop.time() + self.rng.random() * self.tick_s
        k = 0
        hb_every = max(1, int(round(2.0 / self.tick_s)))
        while not self._stopped:
            k += 1
            delay = start + k * self.tick_s - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            try:
                await self._tick_once(hb_every)
            except asyncio.CancelledError:
                raise
            except Exception:
                # Transport hiccup: drop this tick, keep the cadence.
                continue

    async def _tick_once(self, hb_every: int) -> None:
        self._tick += 1
        nid = self.node_id.binary()
        if self._tick % hb_every == 0:
            ok = await self.client.call(
                "heartbeat", nid,
                {"CPU": round(self.rng.uniform(0.0, 4.0), 2)})
            if ok == "unknown":
                await self.client.call(
                    "register_node", nid, self.sim_addr,
                    {"CPU": 4.0, "memory": float(2 << 30)},
                    {"sim": "1", "sim_index": str(self.index)})
            elif ok is False:
                self._stopped = True
                return
        await self.client.call("report_pulse", nid, self._make_pulse())
        self.sent["pulse"] += 1
        tasks, objects = self._make_trail()
        if tasks or objects:
            await self.client.call("report_trail_batch", nid, tasks,
                                   objects)
            self.sent["trail"] += len(tasks) + len(objects)
        logs = self._make_logs()
        if logs:
            await self.client.call("report_log_batch", nid, logs)
            self.sent["log"] += len(logs)
        if self._tick % 2 == 0:
            await self.client.call("report_prof_batch", nid,
                                   [self._make_prof()])
            self.sent["prof"] += 1

    # -- workload models ---------------------------------------------------

    def _make_pulse(self) -> bytes:
        rng = self.rng
        self._seq += 1
        kinds = {}
        for name in _PULSE_KINDS:
            calls = rng.randint(40, 400)
            hist = [0] * graftpulse.PULSE_HIST_BUCKETS
            left = calls
            # Latency mass in buckets 2..6 (~4µs..128µs), the shape the
            # real native planes report on loopback.
            for b in (2, 3, 4, 5, 6):
                n = rng.randint(0, left)
                hist[b] += n
                left -= n
            hist[3] += left
            ns = sum(int(n * 1.5 * (1 << (graftpulse.PULSE_HIST_SHIFT
                                          + b)))
                     for b, n in enumerate(hist))
            kinds[name] = (calls, calls * rng.randint(128, 2048), ns,
                           tuple(hist))
        p = graftpulse.Pulse(
            seq=self._seq,
            t_mono_ns=time.monotonic_ns(),
            t_wall_ns=time.time_ns(),
            store_used=rng.randint(1, 64) << 20,
            store_capacity=1 << 30,
            store_objects=rng.randint(4, 256),
            shm_free_chunks=rng.randint(16, 1024),
            shm_arena_bytes=256 << 20,
            num_workers=4,
            queue_depth=rng.randint(0, 8),
            rss_bytes=(300 << 20) + (self.index << 16),
            scope_dropped=0,
            events_dropped=0,
            prof_oncpu_permille=rng.randint(50, 400),
            prof_gil_permille=rng.randint(10, 120),
            kinds=kinds)
        if self.wire_version == 1:
            return self._encode_v1(p)
        return graftpulse.encode(p)

    @staticmethod
    def _encode_v1(p) -> bytes:
        """A v1 agent's frame: the v2 header minus the trailing prof
        gauges. Exercises the controller's version-skew degrade path."""
        head = graftpulse._V1_RECORD.pack(
            graftpulse.PULSE_MAGIC, 1, graftscope.KIND_COUNT,
            p.seq, p.t_mono_ns, p.t_wall_ns, p.store_used,
            p.store_capacity, p.store_objects, p.shm_free_chunks,
            p.shm_arena_bytes, p.num_workers, p.queue_depth,
            p.rss_bytes, p.scope_dropped, p.events_dropped)
        words: List[int] = []
        for kind in range(graftscope.KIND_COUNT):
            row = p.kinds.get(graftscope.KIND_NAMES.get(kind, ""))
            if row is None:
                words.extend([0] * (3 + graftpulse.PULSE_HIST_BUCKETS))
            else:
                calls, nbytes, ns, hist = row
                words.extend((calls, nbytes, ns))
                words.extend(hist[:graftpulse.PULSE_HIST_BUCKETS])
        return head + struct.pack("<%dQ" % len(words), *words)

    def _make_trail(self) -> Tuple[list, list]:
        rng = self.rng
        ts = time.time()
        tasks: list = []
        # Finish tasks held open from earlier ticks that are now due.
        for tid in [t for t, due in self._open_tasks.items()
                    if due <= self._tick]:
            del self._open_tasks[tid]
            tasks.append((tid, 0, "FINISHED", ts, {"node": self.hex12}))
        for _ in range(rng.randint(1, 4)):
            self._task_seq += 1
            tid = "sim%05x%08x" % (self.index, self._task_seq)
            info = {"name": rng.choice(_TASK_NAMES), "node": self.hex12,
                    "worker": 4000 + self.index}
            tasks.append((tid, 0, "SUBMITTED", ts, info))
            tasks.append((tid, 0, "RUNNING", ts, {"node": self.hex12}))
            if rng.random() < 0.85:
                tasks.append((tid, 0, "FINISHED", ts,
                              {"node": self.hex12}))
            else:
                self._open_tasks[tid] = self._tick + rng.randint(1, 3)
        objects: list = []
        for _ in range(rng.randint(0, 2)):
            self._obj_seq += 1
            oid = "simo%05x%08x" % (self.index, self._obj_seq)
            objects.append((oid, "sealed", ts,
                            {"size": rng.randint(1 << 10, 1 << 20),
                             "plane": "shm", "node": self.hex12}))
            if rng.random() < 0.8:
                objects.append((oid, "freed", ts,
                                {"reason": "out_of_scope"}))
            else:
                self._live_oids.append(oid)
        while len(self._live_oids) > 4:
            objects.append((self._live_oids.pop(0), "freed", ts,
                            {"reason": "lru"}))
        return tasks, objects

    def _make_logs(self) -> list:
        rng = self.rng
        out = []
        for _ in range(rng.randint(1, 3)):
            self._log_seq += 1
            r = rng.random()
            level = 40 if r < 0.02 else 30 if r < 0.08 else 20
            msg = "sim node %d tick %d seq %d" % (
                self.index, self._tick, self._log_seq)
            out.append({"pid": 4000 + self.index, "level": level,
                        "source": 0, "seq": self._log_seq,
                        "t_ns": time.time_ns(), "task": "", "actor": "",
                        "msg": msg, "line_len": len(msg)})
        return out

    def _make_prof(self) -> dict:
        rng = self.rng
        frames = ["<module>", "sim_outer", "sim_inner",
                  rng.choice(_TASK_NAMES)]
        n = rng.randint(10, 60)
        return {"pid": 4000 + self.index, "hz": 29, "frames": frames,
                "stacks": [("", "", frames[3], [0, 1, 2, 3], n)],
                "tasks": [("", "", frames[3], n,
                           n * 1_000_000_000 // 29 // 2,
                           n * 1_000_000_000 // 29 // 8)],
                "threads": [("MainThread",
                             n * 1_000_000_000 // 29 // 2)]}


class SimHost:
    """One RpcServer fronting every sim node on this host.

    All sim nodes register the same (host, port): the controller dials
    one socket per NodeEntry but every agent-side RPC lands here. The
    audit's ``trail_residents`` answers with the UNION of all live sim
    nodes' resident oids — the controller can't tell sim nodes apart by
    address, and a superset keeps the leak check sound (an oid the
    ledger thinks is live IS claimed by its home node's host)."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self.server = RpcServer("simhost")
        self.nodes: List[SimNode] = []
        self.addr: Optional[Tuple[str, int]] = None

    async def start(self) -> Tuple[str, int]:
        async def trail_residents() -> list:
            out = []
            for n in self.nodes:
                if not n.killed:
                    out.extend(n._live_oids)
            return out

        async def _noop(*a, **kw) -> None:
            return None

        self.server.register("trail_residents", trail_residents)
        for m in ("reconcile_bundles", "kill_actor_worker",
                  "commit_bundle", "return_bundle", "return_bundles",
                  "drain_node"):
            self.server.register(m, _noop)
        port = await self.server.start_tcp(self.host, 0)
        self.addr = (self.host, port)
        return self.addr

    async def stop(self) -> None:
        for n in list(self.nodes):
            try:
                await n.stop()
            except Exception:
                pass
        await self.server.stop()
