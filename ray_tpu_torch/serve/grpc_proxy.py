"""gRPC ingress — the second data-plane flavor.

Analogue of the reference's gRPC proxy (reference:
serve/_private/proxy.py:530 gRPCProxy — a grpc.aio server routing
user-proto RPCs to deployment handles). Redesigned proto-less: one
generic byte service, so applications don't compile protos to reach
their deployments —

    service raytpu.serve.ServeAPI {
      rpc Call   (bytes) returns (bytes);          // unary
      rpc Stream (bytes) returns (stream bytes);   // server-streaming
      rpc Routes (bytes) returns (bytes);          // route table / health
    }

Requests are JSON: {"app": name | "route": prefix, "method": optional
replica method, "payload": body}. Call replies {"result": ...} JSON;
Stream yields each item as a bytes frame (text encodes utf-8). gRPC
status codes carry errors (NOT_FOUND for unroutable, INTERNAL for
application failures).
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Optional

from ray_tpu_torch.serve.routing import RouteTable
from ray_tpu_torch.utils import get_logger

logger = get_logger("serve.grpc")

SERVICE = "raytpu.serve.ServeAPI"


class _Identity:
    """bytes-through (de)serializer for the generic service."""

    @staticmethod
    def passthrough(b):
        return b


class GrpcProxy:
    """One per node, like the HTTP proxy (reference runs both ingress
    flavors off the same ProxyActor)."""

    def __init__(self, controller_handle, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 16):
        import grpc

        self._table = RouteTable(controller_handle)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="grpc-proxy"))
        self._server.add_generic_rpc_handlers((_Handler(self._table),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=2).wait(timeout=10)


def _make_handler_class():
    """Defer the grpc import to proxy construction (serve without gRPC
    never pays for it)."""
    import grpc

    class Handler(grpc.GenericRpcHandler):
        def __init__(self, table: RouteTable):
            self._table = table

        def service(self, call_details):
            method = call_details.method
            if method == f"/{SERVICE}/Call":
                return grpc.unary_unary_rpc_method_handler(
                    self._call, request_deserializer=_Identity.passthrough,
                    response_serializer=_Identity.passthrough)
            if method == f"/{SERVICE}/Stream":
                return grpc.unary_stream_rpc_method_handler(
                    self._stream,
                    request_deserializer=_Identity.passthrough,
                    response_serializer=_Identity.passthrough)
            if method == f"/{SERVICE}/Routes":
                return grpc.unary_unary_rpc_method_handler(
                    self._routes,
                    request_deserializer=_Identity.passthrough,
                    response_serializer=_Identity.passthrough)
            return None

        # -- helpers ---------------------------------------------------
        def _resolve(self, request: bytes, context):
            try:
                req = json.loads(request) if request else {}
            except json.JSONDecodeError:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "request must be JSON")
            if not isinstance(req, dict):
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "request must be a JSON object")
            name = req.get("app")
            if name is not None:
                # Validate against the table so an unknown app aborts
                # NOT_FOUND here, not INTERNAL deep in dispatch. The
                # refresh is rate-limited: unknown-app probe storms must
                # not become controller RPC storms.
                if name not in self._table.routes.values() \
                        and self._table.should_refresh():
                    self._table.refresh()
                if name not in self._table.routes.values():
                    name = None
            elif req.get("route"):
                name = self._table.match(req["route"])
                if name is None and self._table.should_refresh():
                    self._table.refresh()
                    name = self._table.match(req["route"])
            if name is None:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"no deployment for {req!r}")
            handle = self._table.handle_for(name)
            if req.get("method"):
                handle = handle.options(method_name=req["method"])
            return handle, req.get("payload")

        # -- RPCs ------------------------------------------------------
        def _call(self, request: bytes, context) -> bytes:
            handle, payload = self._resolve(request, context)
            try:
                result = handle.remote(payload).result(timeout=120)
                return json.dumps({"result": result}).encode()
            except Exception as e:
                # Covers non-JSON-serializable results too: the status
                # contract says application failures are INTERNAL.
                context.abort(grpc.StatusCode.INTERNAL, repr(e))

        def _stream(self, request: bytes, context):
            handle, payload = self._resolve(request, context)
            it = handle.stream(payload)
            try:
                for item in it:
                    if not context.is_active():
                        return  # client left: release the replica stream
                    yield (item if isinstance(item, (bytes, bytearray))
                           else str(item).encode())
            except Exception as e:
                context.abort(grpc.StatusCode.INTERNAL, repr(e))
            finally:
                close = getattr(it, "close", None)
                if close:
                    close()

        def _routes(self, request: bytes, context) -> bytes:
            self._table.refresh()
            return json.dumps(self._table.routes).encode()

    return Handler


_handler_cls: Optional[type] = None


def _Handler(table: RouteTable):
    global _handler_cls
    if _handler_cls is None:
        _handler_cls = _make_handler_class()
    return _handler_cls(table)
