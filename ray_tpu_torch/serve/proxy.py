"""HTTP proxy — the ingress data plane.

Analogue of the reference's proxy (reference: serve/_private/proxy.py
HTTPProxy:706 — ASGI server resolving routes to deployment handles,
streaming responses). Minimal asyncio HTTP/1.1 server: POST/GET
/{route_prefix} with a JSON body dispatches to the deployment's handle
via the pow-2 router; generator deployments stream chunked responses.
Run one per node (reference runs one ProxyActor per node).
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.utils import get_logger

logger = get_logger("serve.proxy")


class HttpProxy:
    def __init__(self, controller_handle, host: str = "127.0.0.1",
                 port: int = 0):
        from ray_tpu_torch.serve.routing import RouteTable
        self._controller = controller_handle
        self._host = host
        self.port = port
        self._table = RouteTable(controller_handle)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._serve_thread,
                                        daemon=True, name="http-proxy")
        self._thread.start()
        self._started.wait(30)

    # -- server plumbing -------------------------------------------------
    def _serve_thread(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        server = self._loop.run_until_complete(
            asyncio.start_server(self._on_client, self._host, self.port))
        self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            server.close()

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    # -- routing (table shared with the gRPC ingress: routing.py) --------
    async def _handle_for(self, path: str) -> Optional[DeploymentHandle]:
        name = self._table.match(path)
        if name is None and self._table.should_refresh():
            # Refresh OFF the event loop (a blocking controller RPC here
            # would stall every in-flight connection), rate-limited so
            # 404 scans can't DoS the ingress.
            await asyncio.get_running_loop().run_in_executor(
                None, self._table.refresh)
            name = self._table.match(path)
        if name is None:
            return None
        return self._table.handle_for(name)

    # -- request handling -------------------------------------------------
    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    return
                method, path, headers, body = request
                await self._dispatch(method, path, headers, body, writer)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            line = await reader.readline()
        except (ConnectionResetError, asyncio.LimitOverrunError):
            return None
        if not line:
            return None
        try:
            method, path, _version = line.decode().split()
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", 0))
        except ValueError:
            return None  # malformed header: drop the connection politely
        body = await reader.readexactly(length) if length > 0 else b""
        return method, path, headers, body

    @staticmethod
    def _respond(writer: asyncio.StreamWriter, status: int, payload: bytes,
                 content_type: str = "application/json") -> None:
        reason = {200: "OK", 404: "Not Found", 500: "Internal Server Error"}
        writer.write(
            f"HTTP/1.1 {status} {reason.get(status, '')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: keep-alive\r\n\r\n".encode() + payload)

    async def _dispatch(self, method: str, path: str, headers, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        if path == "/-/healthz":
            self._respond(writer, 200, b'{"status":"ok"}')
            await writer.drain()
            return
        if path == "/-/routes":
            await asyncio.get_running_loop().run_in_executor(
                None, self._table.refresh)
            self._respond(writer, 200,
                          json.dumps(self._table.routes).encode())
            await writer.drain()
            return
        handle = await self._handle_for(path)
        if handle is None:
            self._respond(writer, 404,
                          json.dumps({"error": f"no route for {path}"})
                          .encode())
            await writer.drain()
            return
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError:
            payload = body.decode(errors="replace")
        loop = asyncio.get_running_loop()
        stream = headers.get("x-serve-stream", "").lower() in ("1", "true")
        if stream:
            # Stream errors terminate the chunked body/connection; a 500
            # status after chunks were sent would corrupt the protocol.
            await self._stream_response(handle, payload, writer, loop)
            return
        try:
            response = await loop.run_in_executor(
                None, lambda: handle.remote(payload).result(timeout=120))
            self._respond(writer, 200, json.dumps(
                {"result": response}).encode())
        except Exception as e:
            self._respond(writer, 500,
                          json.dumps({"error": repr(e)}).encode())
        await writer.drain()

    async def _stream_response(self, handle, payload, writer,
                               loop) -> None:
        """Chunked transfer from a streaming deployment method — tokens
        flow as the replica yields (TTFT = first chunk)."""
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/plain\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")
        await writer.drain()
        # Bounded: a fast producer must not buffer an entire generation
        # for a slow client (the pump blocks on put until the writer
        # drains).
        q: asyncio.Queue = asyncio.Queue(maxsize=16)
        gone = threading.Event()  # client disconnected: stop the producer

        class _ClientGone(Exception):
            pass

        def put_blocking(msg) -> None:
            # Short waits + gone polling: after a disconnect nobody drains
            # the queue, and a blind long block would pin this thread (and
            # the replica-side stream) for minutes.
            # Wait on ONE put future, polling gone between timeouts — a
            # cancel-and-resubmit loop could land the same chunk twice
            # when the cancel races a just-completed put.
            fut = asyncio.run_coroutine_threadsafe(q.put(msg), loop)
            while True:
                try:
                    fut.result(0.5)
                    return
                except TimeoutError:
                    if gone.is_set():
                        fut.cancel()
                        raise _ClientGone()

        def pump():
            it = None
            try:
                it = handle.stream(payload)
                for item in it:
                    if gone.is_set():
                        raise _ClientGone()
                    put_blocking(("item", item))
            except _ClientGone:
                pass
            except BaseException as e:  # noqa: BLE001
                try:
                    put_blocking(("err", repr(e)))
                except Exception:
                    pass
            finally:
                close = getattr(it, "close", None)
                if close:
                    close()  # releases the replica-side stream
                try:
                    put_blocking(("end", None))
                except Exception:
                    pass

        threading.Thread(target=pump, daemon=True).start()
        try:
            while True:
                kind, item = await q.get()
                if kind == "end":
                    break
                if kind == "err":
                    chunk = json.dumps({"error": item}).encode()
                else:
                    chunk = (item if isinstance(item, (bytes, bytearray))
                             else str(item).encode())
                if not chunk:
                    continue  # a 0-length chunk IS the stream terminator
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk
                             + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            gone.set()  # don't decode for a client that left
            raise
