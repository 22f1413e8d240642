"""The PyTorch port's serving engine (ray_tpu_torch.serve) against the JAX
package's on shared tiny weights, on the CPU in f32: the prefill core, the
greedy token streams (exactly), paging, sampling, the in-process LLM server,
and the port's independence from JAX."""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import engine as jeng
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import llm as tllm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=128)
JCFG = jl.LlamaConfig(dtype=np.float32, **KW)
TCFG = tl.LlamaConfig(dtype=torch.float32, **KW)
ENGINE_KW = dict(n_slots=3, decode_chunk=4, page_size=16)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, tl.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def engines(params):
    jp, tp = params
    je = jeng.Engine(jp, JCFG, **ENGINE_KW)
    te = teng.Engine(tp, TCFG, device="cpu", **ENGINE_KW)
    yield je, te
    je.stop()
    te.stop()


def _gen(eng, prompt, n, **kw):
    q = eng.submit(prompt, n, **kw)
    out = []
    while True:
        item = q.get(timeout=120)
        if item is None:
            return out
        out.extend(item)


def _concurrent(eng, jobs):
    """Run (prompt, n, kwargs) jobs at once; returns their streams."""
    outs = [None] * len(jobs)

    def run(i):
        prompt, n, kw = jobs[i]
        outs[i] = _gen(eng, prompt, n, **kw)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    return outs


# Prompts inside one page, spanning pages, and crossing prefill buckets
# (32 -> 64 -> 128).
PROMPTS = [[1, 2, 3], [7] * 20, list(range(1, 41)), list(range(5, 80))]


def test_prefill_core_matches_jax(params):
    jp, tp = params
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :20] = np.arange(3, 23)
    jfirst, jks, jvs, jlogits = jax.jit(jeng._make_prefill_core(JCFG))(
        jp, jnp.asarray(tokens), 20)
    first, ks, vs, logits = teng._make_prefill_core(TCFG)(
        tp, torch.from_numpy(tokens).long(), 20)
    assert int(first) == int(jfirst)
    assert ks.shape == (2, 32, 2, 8) == jks.shape
    for got, want in ((ks, jks), (vs, jvs), (logits, jlogits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_greedy_streams_match_jax_engine(engines):
    je, te = engines
    jobs = [(p, n, {}) for p, n in zip(PROMPTS, (12, 9, 10, 11))]
    want = [_gen(je, p, n) for p, n, _ in jobs]
    assert [len(w) for w in want] == [12, 9, 10, 11]
    # concurrent requests share the port's decode chunks and pages
    assert _concurrent(te, jobs) == want
    # one at a time, too
    assert [_gen(te, p, n) for p, n, _ in jobs] == want


def test_greedy_stream_reaching_max_seq_matches_jax(engines):
    je, te = engines
    prompt = list(range(1, 121))  # 120 + 12 > max_seq 128: cut at the end
    want = _gen(je, prompt, 12)
    # the first token, then decode stops at position max_seq
    assert _gen(te, prompt, 12) == want and len(want) == 9


def test_oversubscription_keeps_bounded_pages(params):
    """12 slots over a pool of 25 pages (about 3 max_seq sequences): 10
    short requests all complete with the solo output, and the peak page
    use stays inside the pool."""
    _, tp = params
    eng = teng.Engine(tp, TCFG, n_slots=12, decode_chunk=4, page_size=16,
                      n_pages=26, device="cpu")
    try:
        solo = _gen(eng, [5, 6, 7], 6)
        outs = _concurrent(eng, [([5, 6, 7], 6, {})] * 10)
        assert all(o == solo for o in outs), outs
        assert eng.peak_pages_used <= 25
        assert eng.pages_in_use() == 0
    finally:
        eng.stop()
    with pytest.raises(ValueError):
        teng.Engine(tp, TCFG, page_size=16, n_pages=8, device="cpu")


def test_sampled_streams_seeded_slot_independent_and_top_k(engines, params):
    _, te = engines
    _, tp = params
    greedy = _gen(te, [1, 2, 3], 8)
    assert _gen(te, [1, 2, 3], 8, temperature=0.0) == greedy
    assert _gen(te, [1, 2, 3], 8, temperature=1.0, top_k=1,
                seed=9) == greedy
    s1 = _gen(te, [1, 2, 3], 8, temperature=1.0, seed=42)
    s3 = _gen(te, [1, 2, 3], 8, temperature=1.0, seed=43)
    assert s1 != s3
    # the same seed in another slot, beside other requests: same stream
    outs = _concurrent(te, [([9, 9], 8, {}),
                            ([1, 2, 3], 8, {"temperature": 1.0, "seed": 43}),
                            ([1, 2, 3], 8, {"temperature": 1.0, "seed": 42})])
    assert outs[1] == s3 and outs[2] == s1
    # every sampled token lies in the top k of the recomputed logits
    prompt = [4, 5, 6, 7]
    toks = _gen(te, prompt, 10, temperature=2.0, top_k=5, seed=7)
    ids = torch.tensor([prompt + toks[:-1]])
    logits = tl.forward(tp, ids, TCFG)[0]
    for i, tok in enumerate(toks):
        top = torch.topk(logits[len(prompt) - 1 + i], 5).indices.tolist()
        assert tok in top, (i, tok, top)


def test_sample_tokens_rules():
    g = np.random.default_rng(0)
    logits = torch.from_numpy(g.standard_normal((4, 100)).astype(np.float32))
    temp = torch.tensor([0.0, 1.0, 1.0, 1.0])
    topk = torch.tensor([0, 1, 0, 3])
    seeds = torch.tensor([5, 5, 5, 5])
    pos = torch.tensor([3, 3, 3, 3])
    out = teng._sample_tokens(logits, temp, topk, seeds, pos)
    argmax = logits.argmax(-1)
    assert out[0] == argmax[0] and out[1] == argmax[1]
    assert out[3] in torch.topk(logits[3], 3).indices
    # the noise depends on (seed, position) only, not on the row
    same = teng._sample_tokens(logits[[2, 2]], temp[2:4].fill_(1.0),
                               torch.tensor([0, 0]), torch.tensor([5, 5]),
                               torch.tensor([3, 3]))
    assert same[0] == same[1] == out[2]
    draws = {int(teng._sample_tokens(logits[2:3], torch.tensor([1.0]),
                                     torch.tensor([0]), torch.tensor([s]),
                                     torch.tensor([3]))) for s in range(40)}
    assert len(draws) > 5  # seeds give different draws
    u = teng._gumbel(torch.tensor([1, 2**62]), torch.tensor([0, 9]), 64)
    assert torch.isfinite(u).all() and u.shape == (2, 64)


def test_submit_prefilled_continues_like_submit(engines, params):
    _, te = engines
    _, tp = params
    prompt = list(range(10, 30))
    full = _gen(te, prompt, 9)
    tokens = torch.zeros((1, 32), dtype=torch.long)
    tokens[0, :20] = torch.tensor(prompt)
    first, ks, vs, _ = teng._make_prefill_core(TCFG)(tp, tokens, 20)
    assert int(first) == full[0]
    q = te.submit_prefilled(ks, vs, 20, int(first), 9)
    rest = []
    while (item := q.get(timeout=60)) is not None:
        rest.extend(item)
    assert rest == full[1:]


def test_llm_server_complete_matches_jax_response_shape():
    import cloudpickle

    from ray_tpu.serve import llm as jllm

    kw = dict(vocab_size=256, d_model=64, n_layers=2, max_seq=64,
              decode_chunk=2, max_ongoing_requests=2)
    body = {"prompt": [1, 2, 3, 4], "max_tokens": 5}
    js = jllm.LLMServer(cloudpickle.dumps(jllm.LLMConfig(num_tpus=0, **kw)))
    ts = tllm.LLMServer(tllm.LLMConfig(device="cpu", **kw))
    try:
        want, got = js.complete(dict(body)), ts.complete(dict(body))
        assert got.keys() == want.keys()
        assert got["object"] == want["object"]
        assert got["model"] == want["model"]
        assert len(got["choices"]) == len(want["choices"]) == 1
        gc, wc = got["choices"][0], want["choices"][0]
        assert gc.keys() == wc.keys()
        assert gc["finish_reason"] == wc["finish_reason"]
        assert len(gc["text"].split()) == len(wc["text"].split()) == 5
        assert ts.mcfg.n_heads == js.mcfg.n_heads
        assert ts.mcfg.n_kv_heads == js.mcfg.n_kv_heads
        with pytest.raises(ValueError):
            list(ts({"prompt": "text without a tokenizer"}))
    finally:
        js.engine.stop()
        ts.stop()
    with pytest.raises(FileNotFoundError):  # as the JAX server's loader
        tllm.LLMServer(tllm.LLMConfig(params_path="/nowhere", device="cpu",
                                      **kw))


def test_entry_points_raise_without_a_card(monkeypatch, params):
    """device=None means the card; with none, nothing carries on on the
    CPU."""
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_params(TCFG, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.Engine(tp, TCFG, **ENGINE_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllm.LLMServer(tllm.LLMConfig(vocab_size=64, d_model=64, n_layers=1,
                                      max_seq=32))


def test_resolve_device_defaults_to_an_indexed_card(monkeypatch):
    """device=None is the current card with its index (the engine's
    threads set it); the CPU is taken as given."""
    from ray_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)


def test_port_imports_no_jax_and_no_ray_tpu():
    """Every module of ray_tpu_torch (the runtime copy included), and
    chip_smoke.py, import without loading jax or anything of ray_tpu."""
    code = (
        "import importlib, pkgutil, sys, ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print(sorted(m for m in sys.modules "
        "if m.startswith('ray_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for mod in ("ray_tpu_torch.ops.attention", "ray_tpu_torch.ops._build",
                "ray_tpu_torch.models.llama", "ray_tpu_torch.serve.engine",
                "ray_tpu_torch.serve.llm", "ray_tpu_torch.api",
                "ray_tpu_torch.state", "ray_tpu_torch.dag",
                "ray_tpu_torch.accelerators",
                "ray_tpu_torch.core.core_worker",
                "ray_tpu_torch.core.controller",
                "ray_tpu_torch.core.node_agent",
                "ray_tpu_torch.core.worker_main",
                "ray_tpu_torch.core.object_store",
                "ray_tpu_torch.core._native.graftrpc",
                "ray_tpu_torch.utils.config",
                "ray_tpu_torch.serve.routing", "ray_tpu_torch.serve.replica",
                "ray_tpu_torch.serve.handle",
                "ray_tpu_torch.serve.controller", "ray_tpu_torch.serve.api",
                "ray_tpu_torch.serve.multiplex", "ray_tpu_torch.serve.proxy",
                "ray_tpu_torch.serve.grpc_proxy",
                "ray_tpu_torch.device_objects",
                "ray_tpu_torch.experimental.device_plane",
                "ray_tpu_torch.experimental.channel",
                "ray_tpu_torch.collective",
                "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.learner",
                "ray_tpu_torch.rllib.env", "ray_tpu_torch.rllib.env_runner",
                "ray_tpu_torch.rllib.replay", "ray_tpu_torch.rllib.ppo",
                "ray_tpu_torch.rllib.impala", "ray_tpu_torch.rllib.dqn",
                "ray_tpu_torch.rllib.sac", "ray_tpu_torch.rllib.multi_agent",
                "ray_tpu_torch.data.llm", "ray_tpu_torch.tune.tuner",
                "ray_tpu_torch.tune.tpe", "ray_tpu_torch.util.queue",
                "ray_tpu_torch.util.actor_pool",
                "ray_tpu_torch.job_submission", "ray_tpu_torch.dashboard",
                "ray_tpu_torch.cli"):
        assert f"'{mod}'" in out.stdout
