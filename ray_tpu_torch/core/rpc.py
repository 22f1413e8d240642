"""Asyncio msgpack RPC — the control-plane transport.

Design note vs the reference: the reference wraps gRPC with typed async
client/server helpers, a retrying client, and chaos injection (reference:
src/ray/rpc/grpc_server.cc, retryable_grpc_client.cc, rpc_chaos.cc). This
framework uses a purpose-built asyncio protocol with msgpack framing instead:
no proto codegen step, lower per-call overhead than Python gRPC, and the same
three facilities — typed handlers, exponential-backoff retry, and
probabilistic request failure injection via the ``testing_rpc_failure`` config
flag (format "method=prob,method2=prob").

Wire format (little-endian u32 length prefix, msgpack body):
  request:  [seqno, method, args_bytes, request_id?]
  response: [seqno, status, payload_bytes]   status: 0 ok, 1 app error
Payloads are opaque bytes; serialization policy lives in the caller layer so
zero-copy buffers can bypass msgpack.

Retry safety: a retried call re-sends the SAME request_id; the server keeps
an LRU cache of completed responses keyed by request_id and replays the
cached response instead of re-executing the handler. This makes retries of
non-idempotent methods (request_lease, store_create, create_actor)
exactly-once per server process — a lost reply never double-executes.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import random
import struct
import time
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch.utils import get_logger
from ray_tpu_torch.utils.aio import spawn
from ray_tpu_torch.utils.config import GlobalConfig

logger = get_logger("rpc")

_LEN = struct.Struct("<I")


class RpcError(Exception):
    pass


class RpcConnectionLost(RpcError):
    pass


class RpcApplicationError(RpcError):
    """Remote handler raised; carries the remote exception."""

    def __init__(self, remote_exc: BaseException):
        super().__init__(repr(remote_exc))
        self.remote_exc = remote_exc


def _chaos_table() -> Dict[str, float]:
    spec = GlobalConfig.testing_rpc_failure
    if not spec:
        return {}
    table = {}
    for part in spec.split(","):
        if "=" in part:
            m, p = part.split("=", 1)
            table[m.strip()] = float(p)
    return table


async def _read_msg(reader: asyncio.StreamReader) -> Any:
    hdr = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(hdr)
    body = await reader.readexactly(n)
    return msgpack.unpackb(body, raw=False)


def _write_msg(writer: asyncio.StreamWriter, msg: Any) -> None:
    body = msgpack.packb(msg, use_bin_type=True)
    writer.write(_LEN.pack(len(body)) + body)


Handler = Callable[..., Awaitable[Any]]


def long_poll(fn: Handler) -> Handler:
    """Mark a handler as legitimately long-running (parks awaiting events):
    exempt from the slow-handler warning of the instrumented loop."""
    fn._rpc_long_poll = True  # type: ignore[attr-defined]
    return fn


class RpcServer:
    """Serves registered async handlers over TCP and/or a unix socket."""

    # Completed-response cache for retry dedup (per server process).
    # Exactly-once depends on entries STAYING cached (an evicted entry lets
    # a retried mutating call re-execute), so eviction is by total byte
    # budget + entry count, oldest first — large bodies stay cached, they
    # just push the budget harder.
    _DEDUP_CAP = 4096
    _DEDUP_MAX_BYTES = 128 * 1024 * 1024

    def __init__(self, name: str = "server"):
        self._name = name
        self._handlers: Dict[str, Handler] = {}
        self._servers: list[asyncio.AbstractServer] = []
        self.port: Optional[int] = None
        # request_id -> Future[(status, payload)] (in-flight or completed)
        self._dedup: "OrderedDict[str, asyncio.Future]" = OrderedDict()
        self._dedup_bytes = 0
        # Per-handler event stats (reference: src/ray/common/asio/
        # instrumented_io_context + event_stats.cc): count, total/max time.
        self.event_stats: Dict[str, list] = {}  # method -> [n, total_s, max_s]
        self._long_poll_methods: set = set()
        self._conns: set = set()  # live client writers (dropped on stop)

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler
        if getattr(handler, "_rpc_long_poll", False):
            self._long_poll_methods.add(method)

    def register_object(self, obj: Any, prefix: str = "") -> None:
        """Register every public async method of obj as `prefix.method`."""
        for name in dir(obj):
            if name.startswith("_"):
                continue
            try:
                fn = getattr(obj, name)
            except Exception:
                continue  # property raising during construction
            if asyncio.iscoroutinefunction(fn):
                self.register(f"{prefix}{name}" if prefix else name, fn)

    async def start_tcp(self, host: str = "127.0.0.1", port: int = 0) -> int:
        srv = await asyncio.start_server(self._on_client, host, port)
        self._servers.append(srv)
        self.port = srv.sockets[0].getsockname()[1]
        return self.port

    async def start_unix(self, path: str) -> None:
        srv = await asyncio.start_unix_server(self._on_client, path)
        self._servers.append(srv)

    async def stop(self) -> None:
        for srv in self._servers:
            srv.close()
        # Closing the listeners only stops NEW connections; a stopped
        # server must also drop established ones so clients see the loss
        # (and fail their pending calls) instead of waiting forever. Drop
        # them BEFORE awaiting wait_closed(): since CPython 3.12.1 it
        # returns only once every connection has closed, so awaiting it
        # first hangs while any client stays connected.
        for w in list(self._conns):
            w.close()
        self._conns.clear()
        for srv in self._servers:
            await srv.wait_closed()
        self._servers.clear()

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    msg = await _read_msg(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                seqno, method, payload = msg[0], msg[1], msg[2]
                rid = msg[3] if len(msg) > 3 else None
                spawn(self._dispatch(seqno, method, payload, writer, rid))
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _execute(self, method: str, payload: bytes) -> Tuple[int, bytes]:
        handler = self._handlers.get(method)
        t0 = time.perf_counter() if GlobalConfig.event_stats_enabled else 0.0
        try:
            if handler is None:
                raise RpcError(f"[{self._name}] no such method: {method}")
            args, kwargs = pickle.loads(payload) if payload else ((), {})
            result = await handler(*args, **kwargs)
            return 0, pickle.dumps(result, protocol=5)
        except BaseException as e:  # noqa: BLE001 — errors cross the wire
            try:
                return 1, pickle.dumps(e, protocol=5)
            except Exception:
                return 1, pickle.dumps(RpcError(repr(e)), protocol=5)
        finally:
            if t0:
                dt = time.perf_counter() - t0
                st = self.event_stats.get(method)
                if st is None:
                    st = self.event_stats[method] = [0, 0.0, 0.0]
                st[0] += 1
                st[1] += dt
                st[2] = max(st[2], dt)
                warn_s = GlobalConfig.handler_warning_timeout_ms / 1000
                # @long_poll handlers legitimately park awaiting events.
                if dt > warn_s and method not in self._long_poll_methods:
                    logger.warning("[%s] handler %s took %.0fms",
                                   self._name, method, dt * 1000)

    async def _dispatch(self, seqno: int, method: str, payload: bytes,
                        writer: asyncio.StreamWriter,
                        rid: Optional[str] = None) -> None:
        delay_us = GlobalConfig.testing_event_loop_delay_us
        if delay_us:
            await asyncio.sleep(delay_us / 1e6)
        if rid is None:
            status, body = await self._execute(method, payload)
        else:
            fut = self._dedup.get(rid)
            if fut is not None:
                # Duplicate (client retry): replay / await the first result
                # instead of re-executing the handler.
                self._dedup.move_to_end(rid)
                status, body = await asyncio.shield(fut)
            else:
                fut = asyncio.get_running_loop().create_future()
                self._dedup[rid] = fut
                status, body = await self._execute(method, payload)
                if not fut.done():
                    fut.set_result((status, body))
                # In-flight entries are never evicted (below), so the entry
                # is still present here; bytes are only ever accounted for
                # entries in the map and subtracted symmetrically on evict.
                if rid in self._dedup:
                    self._dedup_bytes += len(body)
                self._evict_dedup()
        try:
            _write_msg(writer, [seqno, status, body])
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass

    def _evict_dedup(self) -> None:
        """Evict completed entries oldest-first until within budget.

        In-flight entries (long-poll handlers hold them open for minutes)
        are rotated to the tail, never dropped: evicting one would lose the
        exactly-once guard, letting a transport retry of a mutating call
        (e.g. an actor push_task carrying a seqno) re-execute. Their bytes
        were never accounted, so the byte counter stays consistent.
        """
        scanned = 0
        while ((len(self._dedup) > self._DEDUP_CAP
                or self._dedup_bytes > self._DEDUP_MAX_BYTES)
               and scanned < len(self._dedup)):
            old_rid, old_fut = next(iter(self._dedup.items()))
            if not old_fut.done():
                self._dedup.move_to_end(old_rid)
                scanned += 1
                continue
            del self._dedup[old_rid]
            try:
                self._dedup_bytes -= len(old_fut.result()[1])
            except Exception:
                pass


class RpcClient:
    """Multiplexed client: many in-flight calls over one connection.

    Reconnects lazily; `call` retries transient transport failures with
    exponential backoff (reference analogue: retryable_grpc_client.cc).
    """

    def __init__(self, address: Tuple[str, int] | str, *,
                 max_retries: int = 5, timeout: Optional[float] = None):
        self._address = address
        self._max_retries = max_retries
        self._timeout = timeout
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._seqno = 0
        self._recv_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        self._chaos = _chaos_table()
        self._rid_prefix = os.urandom(6).hex()
        self._rid_counter = 0
        self._closed = False
        self._reconnect_task: Optional[asyncio.Task] = None

    async def _ensure_connected(self) -> None:
        if self._closed:
            raise RpcConnectionLost(f"{self._address}: client closed")
        if self._writer is not None and not self._writer.is_closing():
            return
        async with self._lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            if isinstance(self._address, str):
                self._reader, self._writer = await asyncio.open_unix_connection(
                    self._address)
            else:
                host, port = self._address
                self._reader, self._writer = await asyncio.open_connection(
                    host, port)
            self._recv_task = spawn(self._recv_loop())

    async def _recv_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                seqno, status, payload = await _read_msg(self._reader)
                fut = self._pending.pop(seqno, None)
                if fut is None or fut.done():
                    continue
                if status == 0:
                    fut.set_result(pickle.loads(payload))
                else:
                    fut.set_exception(RpcApplicationError(pickle.loads(payload)))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            self._on_conn_lost(RpcConnectionLost(str(self._address)))
        except asyncio.CancelledError:
            raise
        except Exception as e:  # pragma: no cover
            # ANY recv-loop death is a transport loss to callers: wrap it
            # as RpcConnectionLost so pending calls (and their retry
            # loops) treat it as retriable rather than a hard RpcError.
            self._on_conn_lost(
                RpcConnectionLost(f"{self._address}: recv loop died: {e!r}"))

    def _on_conn_lost(self, exc: Exception) -> None:
        """Recv loop died: fail the in-flight calls and start dialing a
        replacement connection in the background with jittered backoff,
        so the next call finds a live transport instead of paying the
        dial (callers that race it still reconnect lazily)."""
        self._fail_pending(exc)
        if not self._closed and self._reconnect_task is None:
            self._reconnect_task = spawn(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        delay = 0.05
        try:
            while not self._closed:
                try:
                    await self._ensure_connected()
                    return
                except (RpcConnectionLost, ConnectionError, OSError):
                    pass
                await asyncio.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, 2.0)
        finally:
            self._reconnect_task = None

    def _fail_pending(self, exc: Exception) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        # Reap the recv loop of the dead connection — reconnects start a
        # fresh one and an orphaned pending task would leak per reconnect.
        if (self._recv_task is not None and not self._recv_task.done()
                and self._recv_task is not asyncio.current_task()):
            self._recv_task.cancel()
            self._recv_task = None
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        prob = self._chaos.get(method) or self._chaos.get("*")
        payload = pickle.dumps((args, kwargs), protocol=5)
        # Retriable calls carry a stable request id so the server can dedup
        # re-sends of a request that already executed (reply lost).
        rid: Optional[str] = None
        if self._max_retries > 0:
            self._rid_counter += 1
            rid = f"{self._rid_prefix}:{self._rid_counter}"
        delay = 0.01
        last: Optional[Exception] = None
        for attempt in range(self._max_retries + 1):
            if prob and random.random() < prob:
                last = RpcConnectionLost(f"chaos-injected failure: {method}")
                await asyncio.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, 1.0)
                continue
            try:
                await self._ensure_connected()
                assert self._writer is not None
                self._seqno += 1
                seqno = self._seqno
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                self._pending[seqno] = fut
                msg = [seqno, method, payload] if rid is None else \
                    [seqno, method, payload, rid]
                _write_msg(self._writer, msg)
                await self._writer.drain()
                if self._timeout:
                    return await asyncio.wait_for(fut, self._timeout)
                return await fut
            except RpcApplicationError:
                raise  # remote handler errors are not retriable here
            except (RpcConnectionLost, ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                last = e if isinstance(e, Exception) else RpcError(repr(e))
                self._fail_pending(RpcConnectionLost(str(self._address)))
                # Jittered exponential backoff: a burst of clients losing
                # one server must not re-dial in lockstep.
                await asyncio.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, 1.0)
        raise last or RpcError("rpc failed")

    async def close(self) -> None:
        self._closed = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
            self._reconnect_task = None
        if self._recv_task:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
            self._recv_task = None
        if self._writer:
            self._writer.close()
            self._writer = None


class SyncRpcClient:
    """Blocking facade over RpcClient for synchronous callers (driver API).

    Owns a private event loop thread; safe to call from any non-async thread.
    """

    def __init__(self, address: Tuple[str, int] | str, **kw):
        import threading

        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True, name="rpc-io")
        self._thread.start()
        self._client = RpcClient(address, **kw)

    def call(self, method: str, *args: Any, timeout: Optional[float] = None,
             **kwargs: Any) -> Any:
        fut = asyncio.run_coroutine_threadsafe(
            self._client.call(method, *args, **kwargs), self._loop)
        return fut.result(timeout)

    def call_async(self, method: str, *args: Any, **kwargs: Any):
        """Fire a call, return a concurrent.futures.Future."""
        return asyncio.run_coroutine_threadsafe(
            self._client.call(method, *args, **kwargs), self._loop)

    def close(self) -> None:
        try:
            asyncio.run_coroutine_threadsafe(
                self._client.close(), self._loop).result(1.0)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=2.0)
