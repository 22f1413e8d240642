"""The port's LLM serving slice as a whole, on its runtime and on the CPU:
the monolithic app (``build_llm_app``), the prefill/decode-disaggregated
app (``run_pd_llm_app``: prefill pool -> DeviceRef KV handoff -> decode
pool, behind ``PDIngress``) and batch inference (``data/llm.py``), at the
size of ``tests/test_serve_llm.py`` (vocab 512, d_model 128, 2 layers,
max_seq 64), every replica with ``num_gpus=0`` and ``device="cpu"``.

The weights come from one checkpoint written by the JAX package's
``save_checkpoint`` and read through ``params_path`` by both packages, so
greedy streams are held against the JAX package's servers exactly (the
token ids, abs 0): through the handle and through HTTP, mono and PD, and
the port's ``_LLMBatchWorker`` against the JAX one on the same batch.
Sampled streams use the port's own noise (not ``jax.random``'s), so a PD
sampled stream is held against the port's mono app with the same seed.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import cloudpickle
import jax
import numpy as np
import pytest

import ray_tpu_torch.serve as serve
from ray_tpu.data import llm as jdllm
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm as jllm
from ray_tpu.train import checkpointing as jckpt
from ray_tpu_torch.core.cluster_utils import Cluster
from ray_tpu_torch.data import llm as tdllm
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve.routing import RouteTable

SIZE = dict(vocab_size=512, d_model=128, n_layers=2, max_seq=64,
            decode_chunk=4, max_ongoing_requests=4)
PROMPTS = [[1, 2, 3, 4], [9, 8], [4, 5, 6, 7, 11, 13], list(range(1, 40))]
MAX_TOKENS = 8
SAMPLED = {"prompt": [1, 2, 3, 4], "max_tokens": 6, "temperature": 1.0,
           "top_k": 40, "seed": 77}
ROUTE_DEADLINE_S = 10 * RouteTable._NEG_CACHE_TTL_S


# A lambda: cloudpickle sends it by value to the replicas (a function of
# this module would go by reference, and the workers cannot import it).
_detok = lambda ids: "".join(f"<{t}>" for t in ids)  # noqa: E731


def _ids(text: str) -> list:
    return [int(t) for t in text.replace(">", "").split("<")[1:]]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX weights for the preset's model, saved by the JAX package."""
    mcfg = jllm._model_from_cfg(jllm.LLMConfig(num_tpus=0, **SIZE))[0]
    params = jl.init_params(mcfg, jax.random.PRNGKey(7))
    return jckpt.save_checkpoint(str(tmp_path_factory.mktemp("llm")),
                                 params, step=0).path


@pytest.fixture(scope="module")
def jax_streams(ckpt):
    """The JAX package's LLMServer, in process, on the checkpoint: the
    greedy token ids of every prompt (each prompt alone)."""
    js = jllm.LLMServer(cloudpickle.dumps(jllm.LLMConfig(
        num_tpus=0, params_path=ckpt, detokenizer=_detok, **SIZE)))
    try:
        return [_ids("".join(js({"prompt": p, "max_tokens": MAX_TOKENS})))
                for p in PROMPTS]
    finally:
        js.engine.stop()


def _cfg(ckpt: str):
    return tllm.LLMConfig(num_gpus=0, device="cpu", params_path=ckpt,
                          detokenizer=_detok, **SIZE)


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(num_nodes=1, resources={"CPU": 8})
    c.connect()
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def apps(cluster, ckpt):
    """The port's mono and PD apps, both on the checkpoint, behind the
    HTTP proxy."""
    try:
        serve.start(http=True)
        cfg = _cfg(ckpt)
        mono = serve.run(tllm.build_llm_app(cfg), name="llm")
        pd = tllm.run_pd_llm_app(cfg, name="pd")
        yield mono, pd
    finally:
        serve.shutdown()


def _http_stream(path: str, body: dict) -> str:
    """A streamed completion through the proxy, retrying a 404 (a route
    not yet in the proxy's table) as a client would."""
    port = serve.get_proxy().port
    deadline = time.monotonic() + ROUTE_DEADLINE_S
    while True:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"x-serve-stream": "1"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.read().decode()
        except urllib.error.HTTPError as e:
            if e.code != 404 or time.monotonic() > deadline:
                raise
        time.sleep(0.25)


def _concurrent(handle, bodies) -> list:
    outs = [None] * len(bodies)

    def run(i):
        outs[i] = "".join(handle.stream(dict(bodies[i])))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    return outs


@pytest.mark.parametrize("app", ["mono", "pd"])
def test_greedy_streams_equal_jax_through_handle_and_http(apps, jax_streams,
                                                          app):
    """Each prompt alone through the handle, all at once through the
    handle (continuous batching), and through HTTP: the JAX server's token
    ids exactly."""
    handle = dict(zip(("mono", "pd"), apps))[app]
    path = {"mono": "/llm", "pd": "/pd"}[app]
    bodies = [{"prompt": p, "max_tokens": MAX_TOKENS} for p in PROMPTS]
    solo = [_ids("".join(handle.stream(dict(b)))) for b in bodies]
    assert solo == jax_streams
    assert [_ids(t) for t in _concurrent(handle, bodies)] == jax_streams
    assert [_ids(_http_stream(path, b)) for b in bodies] == jax_streams


def test_pd_sampled_stream_equals_mono(apps):
    """Temperature 1.0, top_k 40, seed 77: the prefill pool samples the
    first token with the mono engine's (seed, position) noise and the
    decode pool continues it, so PD gives the mono app's stream."""
    mono, pd = apps
    want = "".join(mono.stream(dict(SAMPLED)))
    assert len(_ids(want)) == SAMPLED["max_tokens"]
    assert "".join(pd.stream(dict(SAMPLED))) == want


def test_pd_first_token_alone_and_openai_shape(apps, jax_streams):
    mono, pd = apps
    one = "".join(pd.stream({"prompt": PROMPTS[0], "max_tokens": 1}))
    assert _ids(one) == jax_streams[0][:1]
    resp = pd.options(method_name="complete").remote(
        {"prompt": PROMPTS[1], "max_tokens": MAX_TOKENS}).result(timeout=120)
    assert resp["object"] == "text_completion"
    assert _ids(resp["choices"][0]["text"]) == jax_streams[1]
    resp = mono.options(method_name="complete").remote(
        {"prompt": PROMPTS[1], "max_tokens": MAX_TOKENS}).result(timeout=120)
    assert _ids(resp["choices"][0]["text"]) == jax_streams[1]


def test_pd_options_and_counted_deployments_match(ckpt):
    """run_pd_llm_app's deployments: replicas of num_gpus whole cards for
    both pools, the ingress on none; and chip_smoke.py's counted
    deployments (subclasses with launch readers) keep every option of the
    package's."""
    import chip_smoke

    cfg = _cfg(ckpt)
    pre, dec, ing = tllm._pd_deployments(cfg, "pd", 2, 3)
    assert (pre.name, dec.name, ing.name) == ("pd-prefill", "pd-decode", "pd")
    assert pre._config["num_gpus"] == dec._config["num_gpus"] == 0
    assert (pre._config["num_replicas"], dec._config["num_replicas"]) == (2, 3)
    for want, got in zip((pre, dec, ing),
                         chip_smoke.counted_pd_deployments(cfg, "pd", 2, 3)):
        assert got.name == want.name and got._config == want._config
        assert issubclass(got._cls, want._cls)
    app = tllm.build_llm_app(cfg)
    counted = chip_smoke.counted_llm_app(cfg)
    assert counted.deployment._config == app.deployment._config
    assert counted.deployment.name == app.deployment.name
    assert issubclass(counted.deployment._cls, tllm.LLMServer)
    sent = cloudpickle.loads(counted.init_args[0])
    assert dataclasses.replace(sent, detokenizer=None) == \
        dataclasses.replace(cfg, detokenizer=None)


def _batch() -> dict:
    prompts = np.empty(len(PROMPTS), object)
    prompts[:] = [np.asarray(p, np.int64) for p in PROMPTS]
    return {"prompt": prompts, "row": np.arange(len(PROMPTS))}


def test_batch_worker_matches_jax_in_process(ckpt):
    """The port's _LLMBatchWorker and the JAX one, in process, on the same
    batch: the same greedy "generated" column, token for token."""
    args = ("prompt", "generated", MAX_TOKENS, 0.0, 0, 0)
    jw = jdllm._LLMBatchWorker(cloudpickle.dumps(jllm.LLMConfig(
        num_tpus=0, params_path=ckpt, **SIZE)), *args)
    tw = tdllm._LLMBatchWorker(cloudpickle.dumps(tllm.LLMConfig(
        num_gpus=0, device="cpu", params_path=ckpt, **SIZE)), *args)
    try:
        want = jw(_batch())["generated"]
        got = tw(_batch())["generated"]
    finally:
        jw.engine.stop()
        tw.stop()
    assert len(got) == len(want) == len(PROMPTS)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.tolist() == np.asarray(w).tolist()


def test_llm_processor_through_the_actor_pool(cluster, ckpt, jax_streams):
    """build_llm_processor over a from_items dataset: one engine actor
    (num_gpus=0: no GPU resource asked), the greedy streams of the JAX
    server cut to max_tokens, rows kept."""
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.data.llm import build_llm_processor

    cfg = tllm.LLMConfig(num_gpus=0, device="cpu", params_path=ckpt,
                         **SIZE)
    ds = rdata.from_items([{"prompt": p, "row": i}
                           for i, p in enumerate(PROMPTS)])
    proc = build_llm_processor(cfg, max_tokens=4, concurrency=1,
                               batch_size=2)
    rows = sorted(proc(ds).take_all(), key=lambda r: r["row"])
    assert [r["row"] for r in rows] == list(range(len(PROMPTS)))
    assert [np.asarray(r["generated"]).tolist() for r in rows] == \
        [s[:4] for s in jax_streams]


def test_counted_pd_app_hands_off_by_route_and_frees(apps, ckpt,
                                                     jax_streams):
    """chip_smoke.py's counted PD deployments on the CPU: the same streams,
    launch readers in the replicas (the plain path on CPU tensors counts
    no kernel launch), each request's k and v pulled by the decode pool as
    host bytes (CPU tensors: the route the plane picks before staging),
    and nothing left in the prefill replica's device-object table."""
    import chip_smoke

    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        pd, pre, dec = chip_smoke.run_counted_pd(_cfg(ckpt), "cpd")
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    try:
        bodies = [{"prompt": p, "max_tokens": MAX_TOKENS}
                  for p in PROMPTS[:2]]
        assert [_ids("".join(pd.stream(dict(b)))) for b in bodies] == \
            jax_streams[:2]
        plane = chip_smoke._call(dec, "plane")
        assert plane["pulls_by_route"] == {"cuda_ipc": 0, "host_relay": 4}
        assert plane["relays_by_reason"] == {
            "other_node": 0, "cpu_tensor": 4, "card_not_visible": 0}
        assert chip_smoke._call(pre, "held") == 0
        assert chip_smoke._call(pre, "launches", True) == (0, {})
        assert chip_smoke._call(dec, "launches") == (0, {})
    finally:
        for name in ("cpd", "cpd-prefill", "cpd-decode"):
            serve.delete(name)
