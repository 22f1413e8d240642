"""Long-poll pub/sub — push-style coordination without polling loops.

Analogue of the reference's pubsub layer (reference: src/ray/pubsub/
publisher.cc long-poll batches per subscriber, subscriber.cc resubscribe on
publisher restart; GCS channels for actor state / node info / worker
failures in src/ray/gcs/pubsub_handler.cc). Redesigned for the asyncio
msgpack RPC plane: a hub keeps a bounded per-channel ring of (seq, event)
pairs; subscribers long-poll `poll(channel, from_seq)` and the reply is
either the batch of events since `from_seq` or an empty batch after the
poll timeout. A subscriber that fell behind the ring (seq gap) is told to
resync from authoritative state (the reference handles the same case by
snapshot-then-subscribe).

The hub is transport-agnostic: the controller exposes it as the
`pubsub_poll` RPC; core workers can host their own hub for owner-side
channels (object locations, ref removal).
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.utils import get_logger

logger = get_logger("pubsub")


class PubsubHub:
    """In-process hub: named channels of monotonically-sequenced events."""

    def __init__(self, ring_size: int = 4096):
        import os
        self._ring_size = ring_size
        self._rings: Dict[str, deque] = {}
        self._next_seq: Dict[str, int] = {}
        self._waiters: Dict[str, List[asyncio.Event]] = {}
        # Epoch id: lets subscribers detect a publisher RESTART (fresh
        # sequence space) even after the new space catches up to their
        # old cursor — a bare next_seq comparison cannot.
        self.epoch = os.urandom(8).hex()

    def publish(self, channel: str, event: Any) -> int:
        """Append an event; wake every parked poller on the channel."""
        seq = self._next_seq.get(channel, 0)
        self._next_seq[channel] = seq + 1
        ring = self._rings.get(channel)
        if ring is None:
            ring = self._rings[channel] = deque(maxlen=self._ring_size)
        ring.append((seq, event))
        for ev in self._waiters.pop(channel, ()):
            ev.set()
        return seq

    def _collect(self, channel: str, from_seq: int
                 ) -> Tuple[List[Any], int, bool]:
        """Events with seq >= from_seq, next_seq, and whether a gap occurred
        (subscriber older than the ring: must resync from full state)."""
        ring = self._rings.get(channel)
        nxt = self._next_seq.get(channel, 0)
        if from_seq < 0:  # "subscribe from latest": cursor only, no replay
            return [], nxt, False
        if not ring or from_seq >= nxt:
            return [], nxt, False
        oldest = ring[0][0]
        gap = from_seq < oldest
        events = [e for s, e in ring if s >= from_seq]
        return events, nxt, gap

    async def poll(self, channel: str, from_seq: int,
                   timeout: float = 30.0) -> dict:
        """Long-poll: return immediately if events are pending, else park
        until a publish or the timeout. Reply shape:
        {"events": [...], "next_seq": int, "gap": bool}"""
        events, nxt, gap = self._collect(channel, from_seq)
        if from_seq < 0:
            # Cursor fetch ("subscribe from latest") must NOT park:
            # anything published while parked would fall between the
            # returned cursor and the events the parked poll discards.
            return {"events": [], "next_seq": nxt, "gap": False,
                    "epoch": self.epoch}
        if not events:
            ev = asyncio.Event()
            self._waiters.setdefault(channel, []).append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            finally:
                # publish() pops the whole list; on timeout we must drop
                # our own entry or quiet channels leak one Event per poll.
                lst = self._waiters.get(channel)
                if lst is not None and ev in lst:
                    lst.remove(ev)
            events, nxt, gap = self._collect(channel, from_seq)
        return {"events": events, "next_seq": nxt, "gap": gap,
                "epoch": self.epoch}


class Subscription:
    """Client-side subscription loop over the `pubsub_poll` RPC.

    Calls `handler(event)` for each event in order; `on_gap()` (if given)
    when the hub reports the subscriber fell behind. Runs until cancelled.
    """

    def __init__(self, client, channel: str,
                 handler: Callable[[Any], Any],
                 on_gap: Optional[Callable[[], Any]] = None,
                 poll_timeout: float = 30.0,
                 method: str = "pubsub_poll",
                 from_latest: bool = False):
        self._client = client
        self._channel = channel
        self._handler = handler
        self._on_gap = on_gap
        self._poll_timeout = poll_timeout
        self._method = method
        self._task: Optional[asyncio.Task] = None
        # from_latest: skip history (a late joiner must not replay stale
        # events, e.g. a "dead" event for an address a new node reuses).
        self.next_seq = -1 if from_latest else 0
        self._epoch: Optional[str] = None

    def start(self) -> "Subscription":
        from ray_tpu_torch.utils.aio import spawn as _spawn
        self._task = _spawn(self._run())
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def retarget(self, client) -> None:
        """Point the poll loop at a replacement hub (controller head
        failover): the next poll round uses the new client; the
        epoch-restart detection then resyncs the sequence cursor."""
        self._client = client

    async def _run(self) -> None:
        while True:
            try:
                reply = await self._client.call(
                    self._method, self._channel, self.next_seq,
                    self._poll_timeout)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.debug("pubsub poll on %r failed: %r", self._channel, e)
                await asyncio.sleep(1.0)
                continue
            # Fell behind the ring OR the publisher restarted (new
            # epoch = fresh sequence space): resync from authoritative
            # state once.
            epoch = reply.get("epoch")
            restarted = (self._epoch is not None and epoch is not None
                         and epoch != self._epoch)
            self._epoch = epoch
            if reply.get("gap") or restarted:
                if restarted:
                    self.next_seq = 0
                    reply = {"events": [], "next_seq": 0, "gap": False}
                if self._on_gap is not None:
                    try:
                        res = self._on_gap()
                        if asyncio.iscoroutine(res):
                            await res
                    except Exception:
                        logger.exception("pubsub on_gap handler failed")
            for event in reply["events"]:
                try:
                    res = self._handler(event)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    logger.exception("pubsub handler failed on %r",
                                     self._channel)
            self.next_seq = reply["next_seq"]
