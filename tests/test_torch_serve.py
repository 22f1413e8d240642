"""The port's serve layer (``ray_tpu_torch.serve``): the cases of
``tests/test_serve.py`` with the same deployments and assertions on the
port's runtime — deploy and call, method routing, ``@batch``, pow-2
balance, streaming, HTTP round trip and streaming, autoscaling up, pubsub
invalidation, multiplexing with LRU eviction, bound children, and gRPC
unary and streaming where ``grpc`` imports — plus ``num_gpus`` checks.

HTTP tests wait for a new route as a client would: the proxy refreshes
its route table at most once per ``RouteTable._NEG_CACHE_TTL_S`` (2 s, as
the reference does), so a miss on another path within that window makes a
new route answer 404 until the window ends. ``_http`` polls the route
until it answers, with a deadline well past that window, so no test here
depends on the order the tests run in.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
import ray_tpu_torch.serve as serve
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.serve.routing import RouteTable

# Longer than the route table's refresh window: a client that retries
# a 404 for this long sees a route that exists.
ROUTE_DEADLINE_S = 10 * RouteTable._NEG_CACHE_TTL_S


def _http(port: int, path: str, body: bytes, headers=None,
          timeout: float = 30):
    """POST ``body`` to ``path`` and return (status, response bytes),
    retrying a 404 until ROUTE_DEADLINE_S has passed."""
    deadline = time.monotonic() + ROUTE_DEADLINE_S
    while True:
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=body, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            if e.code != 404 or time.monotonic() > deadline:
                return e.code, e.read()
        time.sleep(0.25)


@pytest.fixture(scope="module")
def cluster():
    # One advertised GPU (no card is touched): num_gpus pinning.
    c = Cluster(num_nodes=1, resources={"CPU": 12, "GPU": 1})
    c.connect()
    serve.start(http=True)
    yield c
    serve.shutdown()
    c.shutdown()


def test_async_actor_concurrency(cluster):
    """Core prerequisite: async actor methods run concurrently."""
    @ray_tpu_torch.remote
    class Sleeper:
        async def nap(self, s):
            import asyncio
            await asyncio.sleep(s)
            return s

        async def ping(self):
            return "pong"

    a = Sleeper.remote()
    t0 = time.monotonic()
    refs = [a.nap.remote(1.0) for _ in range(5)]
    # A probe completes while naps are in flight.
    assert ray_tpu_torch.get(a.ping.remote(), timeout=5) == "pong"
    assert ray_tpu_torch.get(refs, timeout=30) == [1.0] * 5
    elapsed = time.monotonic() - t0
    assert elapsed < 4.0, f"async naps serialized ({elapsed:.1f}s)"


def test_deploy_and_call(cluster):
    @serve.deployment(num_replicas=2)
    class Echo:
        async def __call__(self, x):
            return {"echo": x}

    handle = serve.run(Echo.bind(), name="echo")
    assert handle.remote("hi").result(timeout=30) == {"echo": "hi"}
    out = [handle.remote(i).result(timeout=30)["echo"] for i in range(10)]
    assert out == list(range(10))


def test_method_routing_and_composition(cluster):
    @serve.deployment
    class Calc:
        async def add(self, a, b):
            return a + b

        async def __call__(self, x):
            return x

    handle = serve.run(Calc.bind(), name="calc")
    assert handle.options(method_name="add").remote(2, 3).result(
        timeout=30) == 5


def test_batching(cluster):
    @serve.deployment
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def __call__(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        async def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batcher.bind(), name="batcher")
    responses = [handle.remote(i) for i in range(8)]
    results = [r.result(timeout=30) for r in responses]
    assert sorted(results) == [i * 10 for i in range(8)]
    sizes = handle.options(method_name="sizes").remote().result(timeout=30)
    assert max(sizes) > 1, f"no batching happened: {sizes}"


def test_pow2_balances_load(cluster):
    @serve.deployment(num_replicas=2)
    class Who:
        def __init__(self):
            import os
            self.pid = os.getpid()

        async def __call__(self, _):
            return self.pid

    handle = serve.run(Who.bind(), name="who")
    pids = {handle.remote(None).result(timeout=30) for _ in range(20)}
    assert len(pids) == 2, "pow-2 router never used the second replica"


def test_streaming_response(cluster):
    @serve.deployment
    class Tokens:
        def generate(self, n):
            for i in range(n):
                yield f"tok{i} "

    handle = serve.run(Tokens.bind(), name="tokens")
    out = list(handle.options(method_name="generate").stream(4))
    assert out == ["tok0 ", "tok1 ", "tok2 ", "tok3 "]


def test_http_proxy_roundtrip(cluster):
    @serve.deployment
    class Sum:
        async def __call__(self, body):
            return {"sum": body["a"] + body["b"]}

    serve.run(Sum.bind(), name="sum")
    port = serve.get_proxy().port
    status, out = _http(port, "/sum", json.dumps({"a": 2, "b": 40}).encode(),
                        {"Content-Type": "application/json"})
    assert status == 200
    assert json.loads(out)["result"] == {"sum": 42}
    # Unknown route -> 404
    try:
        urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/nope",
                                   data=b"{}"), timeout=30)
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_http_streaming(cluster):
    @serve.deployment
    class Streamer:
        def __call__(self, body):
            for i in range(3):
                yield f"c{i}|"

    serve.run(Streamer.bind(), name="streamer")
    port = serve.get_proxy().port
    status, out = _http(port, "/streamer", b"{}", {"x-serve-stream": "1"})
    assert status == 200
    assert out.decode() == "c0|c1|c2|"


def test_autoscaling_up(cluster):
    @serve.deployment(num_replicas=1, autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0, "upscale_delay_s": 0.5})
    class Slow:
        async def __call__(self, _):
            import asyncio
            await asyncio.sleep(0.5)
            return "done"

    handle = serve.run(Slow.bind(), name="slow")
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                handle.remote(None).result(timeout=30)
            except Exception:
                pass

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(6)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 30
        scaled = False
        controller = serve.start()
        while time.monotonic() < deadline:
            info = ray_tpu_torch.get(controller.list_deployments.remote(),
                               timeout=15)
            if info["slow"]["num_replicas"] > 1:
                scaled = True
                break
            time.sleep(0.5)
        assert scaled, "autoscaler never scaled up under sustained load"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)


def test_router_pubsub_push_invalidation(cluster):
    """A redeploy must reach an existing handle's router via pubsub well
    inside the 30s TTL fallback (reference: long_poll push updates)."""
    import time as _time

    @serve.deployment(num_replicas=1)
    class V:
        def __call__(self, _):
            return "v1"

    handle = serve.run(V.bind(), name="pushinval")
    assert handle.remote(None).result(timeout=60) == "v1"

    @serve.deployment(num_replicas=1)
    class V2:
        def __call__(self, _):
            return "v2"

    serve.run(V2.bind(), name="pushinval")
    deadline = _time.time() + 8.0  # << router TTL (30s): needs the push
    while _time.time() < deadline:
        try:
            if handle.remote(None).result(timeout=30) == "v2":
                break
        except Exception:
            pass
        _time.sleep(0.2)
    assert handle.remote(None).result(timeout=30) == "v2"
    serve.delete("pushinval")


def test_model_multiplexing(cluster):
    """Per-replica LRU model cache + sticky routing + model id context
    (reference: serve/multiplex.py, serve.multiplexed API)."""
    import os

    @serve.deployment(num_replicas=2)
    class Mux:
        def __init__(self):
            self.loads = []
            self._get = serve.multiplexed(
                max_num_models_per_replica=2)(self._load)

        def _load(self, model_id):
            self.loads.append(model_id)
            return {"id": model_id, "pid": os.getpid()}

        def __call__(self, _):
            model = self._get(serve.get_multiplexed_model_id())
            return {"model": model["id"], "pid": model["pid"],
                    "loads": list(self.loads)}

    handle = serve.run(Mux.bind(), name="mux")
    h_a = handle.options(multiplexed_model_id="model-a")
    h_b = handle.options(multiplexed_model_id="model-b")
    first = h_a.remote(None).result(timeout=60)
    assert first["model"] == "model-a"
    # Sticky: repeats for the same model hit the same replica and do NOT
    # reload (loads stays length-1 on that replica).
    for _ in range(4):
        again = h_a.remote(None).result(timeout=60)
        assert again["pid"] == first["pid"]
        assert again["loads"].count("model-a") == 1
    outb = h_b.remote(None).result(timeout=60)
    assert outb["model"] == "model-b"
    serve.delete("mux")


def test_model_multiplexing_lru_eviction(cluster):
    """One replica, capacity 2: the third model evicts the LRU one, so a
    re-request of the evicted model reloads it."""
    @serve.deployment(num_replicas=1)
    class Mux1:
        def __init__(self):
            self.loads = []
            self._get = serve.multiplexed(
                max_num_models_per_replica=2)(self._load)

        def _load(self, model_id):
            self.loads.append(model_id)
            return model_id

        def __call__(self, _):
            self._get(serve.get_multiplexed_model_id())
            return list(self.loads)

    handle = serve.run(Mux1.bind(), name="mux1")
    for mid in ("a", "b", "c"):  # c evicts a (capacity 2)
        handle.options(multiplexed_model_id=mid).remote(None).result(
            timeout=60)
    loads = handle.options(multiplexed_model_id="a").remote(None).result(
        timeout=60)
    assert loads == ["a", "b", "c", "a"], loads  # a was reloaded
    # b was evicted by a's reload; c is still resident.
    loads = handle.options(multiplexed_model_id="c").remote(None).result(
        timeout=60)
    assert loads == ["a", "b", "c", "a"], loads  # c cached, no reload
    serve.delete("mux1")


def test_num_gpus_pins_whole_cards(cluster):
    """Replicas take whole cards (``num_gpus``, the reference's
    ``num_tpus``): one card pins CUDA_VISIBLE_DEVICES, none leaves the
    worker's environment as the node's (a replica then sees every card);
    a fraction is refused where the deployment is declared."""
    with pytest.raises(ValueError, match="whole number"):
        serve.deployment(num_gpus=0.5)

    @serve.deployment(num_gpus=1)
    class Devices:
        def __call__(self, _):
            import os
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    pinned = serve.run(Devices.bind(), name="pinned")
    assert pinned.remote(None).result(timeout=60) == "0"
    free = serve.run(Devices.options(num_gpus=0).bind(), name="unpinned")
    assert free.remote(None).result(timeout=60) == \
        os.environ.get("CUDA_VISIBLE_DEVICES")
    serve.delete("pinned")
    serve.delete("unpinned")


def test_grpc_ingress_unary_and_streaming():
    """gRPC ingress (reference: serve/_private/proxy.py:530 gRPCProxy):
    unary Call, server-streaming Stream, route resolution by app name
    and route prefix, NOT_FOUND/INTERNAL status mapping."""
    import json

    grpc = pytest.importorskip("grpc")

    c = Cluster(num_nodes=1, resources={"CPU": 6})
    c.connect()
    try:
        serve.start(grpc=True)

        @serve.deployment
        class Echo:
            def __call__(self, body):
                return {"echo": body}

            def fail(self, body):
                raise ValueError("boom")

            def counted(self, n):
                for i in range(int(n)):
                    yield f"tok{i} "

        serve.run(Echo.bind(), name="echo")
        port = serve.get_grpc_proxy().port
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = ch.unary_unary("/raytpu.serve.ServeAPI/Call")
        stream = ch.unary_stream("/raytpu.serve.ServeAPI/Stream")
        routes = ch.unary_unary("/raytpu.serve.ServeAPI/Routes")

        # Routes endpoint sees the deployment.
        table = json.loads(routes(b""))
        assert table.get("/echo") == "echo"

        # Unary by app name and by route prefix.
        out = json.loads(call(json.dumps(
            {"app": "echo", "payload": {"x": 1}}).encode()))
        assert out == {"result": {"echo": {"x": 1}}}
        out = json.loads(call(json.dumps(
            {"route": "/echo", "payload": "hi"}).encode()))
        assert out == {"result": {"echo": "hi"}}

        # Server streaming (generator method).
        frames = list(stream(json.dumps(
            {"app": "echo", "method": "counted", "payload": 4}).encode()))
        assert b"".join(frames) == b"tok0 tok1 tok2 tok3 "

        # Unroutable -> NOT_FOUND; application error -> INTERNAL.
        try:
            call(json.dumps({"app": "nope", "payload": 1}).encode())
            assert False, "expected NOT_FOUND"
        except grpc.RpcError as e:
            assert e.code() == grpc.StatusCode.NOT_FOUND
        try:
            call(json.dumps({"app": "echo", "method": "fail",
                             "payload": 1}).encode())
            assert False, "expected INTERNAL"
        except grpc.RpcError as e:
            assert e.code() == grpc.StatusCode.INTERNAL
        ch.close()
    finally:
        serve.shutdown()
        c.shutdown()


def test_app_composition_bound_children():
    """Model composition (reference: serve/handle.py deployment graphs):
    a parent bound with child Applications gets live DeploymentHandles
    in its constructor; children deploy automatically with the parent."""
    c = Cluster(num_nodes=1, resources={"CPU": 6})
    c.connect()
    try:
        serve.start()

        @serve.deployment
        class Doubler:
            def __call__(self, x):
                return x * 2

        @serve.deployment
        class Adder:
            def __call__(self, x):
                return x + 100

        @serve.deployment
        class Combiner:
            def __init__(self, doubler, adder):
                self._doubler = doubler
                self._adder = adder

            def __call__(self, x):
                d = self._doubler.remote(x).result(timeout=60)
                a = self._adder.remote(x).result(timeout=60)
                return {"doubled": d, "added": a}

        h = serve.run(Combiner.bind(Doubler.bind(), Adder.bind()),
                      name="combo")
        out = h.remote(7).result(timeout=120)
        assert out == {"doubled": 14, "added": 107}
        # Children are addressable deployments in their own right.
        assert serve.get_deployment_handle(
            "Doubler").remote(3).result(timeout=60) == 6
    finally:
        serve.shutdown()
        c.shutdown()
