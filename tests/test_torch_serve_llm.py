"""Serving on the port, against the JAX package where a result can be
compared: the five serve cases of ``tests/test_libraries.py`` (replicas
behind power-of-two choices, the HTTP proxy, autoscaling under load, the
aiohttp proxy's health routes and SSE, the cluster-RPC gRPC ingress), and
``tests/test_llm.py``'s ``test_llm_serving`` and
``test_llm_deployment_streams_over_http`` with ``device="cpu"``, each
generated text or token stream equal to the JAX engine's fed the same
weights (``params_from_jax``, f32). Then what the port adds: the HTTP
proxy on the standard library's server (the path the chip machine, which
has no aiohttp, runs), a router fleet's cross-router failover of an LLM
stream, token-exact against the JAX engine, the weights hub's round trip
of host tensors (bf16 as its bits) and ``_params_sig``.
"""
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core.runtime import set_runtime
from ray_tpu_torch.models import transformer as T


@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


@pytest.fixture()
def rt(tmp_path):
    rt = ray_tpu_torch.init(
        num_nodes=2,
        resources_per_node={"CPU": 8, "memory": float(1 << 30)},
    )
    yield rt
    import ray_tpu_torch.serve as serve

    serve.shutdown()
    ray_tpu_torch.shutdown()


# -- tests/test_libraries.py's serve cases -----------------------------------


def test_serve_deployment_and_p2c(rt):
    import ray_tpu_torch.serve as serve

    @serve.deployment(num_replicas=2)
    class Doubler:
        def __call__(self, x):
            return 2 * x

        def name(self):
            return "doubler"

    handle = serve.run(Doubler.bind())
    results = ray_tpu_torch.get([handle.remote(i) for i in range(20)])
    assert results == [2 * i for i in range(20)]
    assert ray_tpu_torch.get(handle.name.remote()) == "doubler"


def test_serve_http_proxy(rt):
    import json
    import urllib.request

    import ray_tpu_torch.serve as serve

    @serve.deployment
    def echo(payload):
        return {"got": payload}

    serve.run(echo.bind())
    port = serve.start_http_proxy(port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/echo",
        data=json.dumps({"a": 1}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["result"] == {"got": {"a": 1}}


def test_serve_autoscaling_up(rt):
    import ray_tpu_torch.serve as serve

    @serve.deployment(
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 3,
            "target_ongoing_requests": 1,
        }
    )
    class Slow:
        def __call__(self, x):
            time.sleep(0.4)
            return x

    handle = serve.run(Slow.bind())
    assert handle.num_replicas == 1
    refs = [handle.remote(i) for i in range(12)]
    deadline = time.monotonic() + 8.0
    while handle.num_replicas <= 1 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert handle.num_replicas > 1  # scaled up under load
    assert sorted(ray_tpu_torch.get(refs)) == list(range(12))


def test_serve_async_proxy_health_routes_and_sse(rt):
    """The aiohttp proxy tier: health/routes endpoints and Server-Sent
    Event streaming through a deployment's Channel-writing method."""
    pytest.importorskip("aiohttp")
    import json
    import urllib.request

    import ray_tpu_torch.serve as serve

    @serve.deployment
    class Streamer:
        def __call__(self, payload):
            return {"ok": True}

        def stream_to(self, writer, payload):
            n = int(payload["n"])
            for i in range(n):
                writer.write({"tok": i})
            writer.close_channel()
            return n

    serve.run(Streamer.bind())
    port = serve.start_http_proxy(port=0)
    base = f"http://127.0.0.1:{port}"
    with urllib.request.urlopen(f"{base}/-/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and "Streamer" in health["deployments"]
    with urllib.request.urlopen(f"{base}/-/routes", timeout=30) as r:
        assert "Streamer" in json.loads(r.read())
    req = urllib.request.Request(
        f"{base}/Streamer/stream",
        data=json.dumps({"n": 5}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        body = resp.read().decode()
    events = [
        json.loads(line[len("data: "):])
        for line in body.splitlines()
        if line.startswith("data: ") and "tok" in line
    ]
    assert events == [{"tok": i} for i in range(5)]
    assert "event: end" in body


def test_serve_grpc_ingress(rt):
    """gRPC front door (reference: serve gRPCProxy): unary calls and
    ordered token streaming over the framework's gRPC wire."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster.rpc import RpcClient

    @serve.deployment
    class Doubler:
        def __call__(self, payload):
            return {"doubled": payload["v"] * 2}

        def stream_to(self, writer, payload):
            for i in range(payload["n"]):
                writer.write({"tok": i})
            writer.close_channel()

    serve.run(Doubler.bind())
    addr = serve.start_grpc_ingress(0)
    cli = RpcClient(addr)
    try:
        out = cli.call(
            "ServeCall", {"deployment": "Doubler", "payload": {"v": 21}}
        )
        assert out == {"doubled": 42}
        assert cli.call("ServeRoutes", {}) == ["Doubler"]
        # streaming: open -> drain -> close
        sid = cli.call(
            "ServeStreamOpen",
            {"deployment": "Doubler", "payload": {"n": 7}},
        )
        got = []
        for _ in range(20):
            rep = cli.call(
                "ServeStreamNext",
                {"stream_id": sid, "max_items": 3, "timeout": 5.0},
            )
            got.extend(rep["items"])
            if rep["ended"]:
                break
        assert got == [{"tok": i} for i in range(7)], got
        cli.call("ServeStreamClose", {"stream_id": sid})
    finally:
        cli.close()
        serve.shutdown()



# -- LLM deployments against the JAX engines ---------------------------------

SMALL = dict(vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=256)
ENGINE = dict(max_batch=2, page_size=8, n_pages=64)


def _models(seed=0):
    """(JAX config, JAX params, port config, the same params on the port)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as J

    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    pj = J.init_params(cj, jax.random.PRNGKey(seed))
    ct = T.ModelConfig(dtype=torch.float32, **SMALL)
    return cj, pj, ct, T.params_from_jax(jax.tree.map(np.asarray, pj), "cpu")


def _jax_stream(cj, pj, prompt, n):
    """The JAX continuous engine's token texts for one greedy request."""
    from ray_tpu.llm.continuous import ContinuousBatchingEngine as JEngine
    from ray_tpu.llm.engine import GenerationConfig as JGen

    eng = JEngine(cj, pj, **ENGINE)
    ids = eng.stream_ids(eng.tokenizer.encode(prompt), JGen(max_new_tokens=n))
    return [eng.tokenizer.decode([int(t)]) for t in ids]


def _sse_tokens(body):
    toks, event = [], "message"
    for line in body.splitlines():
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            if event == "message":
                toks.append(json.loads(line[len("data: "):]))
            event = "message"
    return toks


def test_llm_serving():
    """The dense engine behind a deployment: the generated text equals the
    JAX ``LLMEngine``'s for the same weights."""
    from ray_tpu.llm import GenerationConfig as JGen
    from ray_tpu.llm import LLMEngine as JLLMEngine

    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.llm import build_llm_deployment

    cj, pj, ct, pt = _models()
    want = JLLMEngine(cj, pj, max_len=64).generate(["hi"], JGen(max_new_tokens=4))[0]
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4, "memory": 1e9})
    try:
        handle = serve.run(build_llm_deployment(ct, pt, max_len=64, device="cpu"))
        out = ray_tpu_torch.get(
            handle.remote({"prompt": "hi", "max_new_tokens": 4}), timeout=120
        )
        assert out["prompt"] == "hi"
        assert out["generated_text"] == want
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_llm_deployment_streams_over_http():
    """build_llm_deployment(engine='continuous') streams decoded token
    text via POST /<name>/stream (the aiohttp proxy) with zero user code,
    token-exact against the JAX continuous engine."""
    pytest.importorskip("aiohttp")
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.llm import build_llm_deployment

    cj, pj, ct, pt = _models()
    want = _jax_stream(cj, pj, "hi", 6)
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        serve.run(build_llm_deployment(ct, pt, name="sllm", engine="continuous",
                                       device="cpu", **ENGINE))
        port = serve.start_http_proxy(port=0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/sllm/stream",
            data=json.dumps({"prompt": "hi", "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read().decode()
        assert _sse_tokens(body) == want
        assert "event: end" in body
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_http_proxy_on_the_standard_library_server(monkeypatch):
    """Without aiohttp (as on the chip machine), ``start_http_proxy``
    serves POST /<name> on ``ThreadingHTTPServer``: the text equals the
    router's unary call and the JAX engine's."""
    import importlib
    import importlib.util

    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.serve import proxy

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "aiohttp" else find_spec(name, *a))
    cj, pj, ct, pt = _models()
    want = "".join(_jax_stream(cj, pj, "hello", 5))
    ray_tpu_torch.init(num_nodes=1, resources_per_node={"CPU": 4})
    try:
        serve.run(build_llm_deployment(ct, pt, name="plain", engine="continuous",
                                       device="cpu", **ENGINE))
        port = serve.start_http_proxy(port=0)
        server = importlib.import_module("ray_tpu_torch.serve.deployment")._http_server
        assert not isinstance(server, proxy.ServeProxy)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/plain",
            data=json.dumps({"prompt": "hello", "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        routed = serve.get_router("plain").call(
            {"prompt": "hello", "max_new_tokens": 5}, timeout=120)
        assert body["result"]["generated_text"] == routed["generated_text"] == want
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_llm_stream_fails_over_across_routers_token_exact(monkeypatch):
    """Two routers in front of two continuous replicas in worker
    processes; the router owning a stream is killed mid-stream. The stream
    resumes on the sibling, and its tokens equal the JAX engine's."""
    import ray_tpu_torch.serve as serve
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.llm import build_llm_deployment

    monkeypatch.setenv("RAY_TPU_SERVE_ROUTERS", "2")
    # the push transport: a router kill severs push-sink streams, where
    # same-host shm rings would ride it out
    monkeypatch.setenv("RAY_TPU_SERVE_SHM_STREAMS", "0")
    cj, pj, ct, pt = _models()
    n = 160
    want = _jax_stream(cj, pj, "the fleet", n)
    c = Cluster(use_device_scheduler=False)
    c.add_node({"CPU": 8.0}, num_workers=3)
    rt = c.client()
    set_runtime(rt)
    try:
        serve.run(build_llm_deployment(ct, pt, name="fleetllm", engine="continuous",
                                       num_replicas=2, device="cpu", **ENGINE))
        fleet = serve.get_router("fleetllm")
        assert fleet.resumable and len(fleet.routers) == 2
        tenant = next(f"t{i}" for i in range(100)
                      if fleet.router_for(f"t{i}") == "fleetllm/r0")
        stream = fleet.stream({"prompt": "the fleet", "max_new_tokens": n}, tenant)
        got = [stream.read(timeout=120) for _ in range(3)]
        assert fleet.chaos_kill_router(rid=stream._rid) == "fleetllm/r0"
        got += list(stream)
        assert stream.router_failovers >= 1
        assert got == want
    finally:
        serve.shutdown()
        set_runtime(None)
        rt.shutdown()
        c.shutdown()


# -- the weights hub and the prefix cache's weight signature -----------------


def test_weights_hub_round_trips_host_tensors_bf16_as_bits():
    from ray_tpu_torch.serve.model_store import WeightsHub
    from ray_tpu_torch.serve.prefix_cache import node_store

    store = node_store()
    assert store is not None
    hub = WeightsHub(store, f"hubtest-{time.monotonic_ns()}")
    g = torch.Generator().manual_seed(3)
    params = {"blocks": {"w": torch.randn(2, 8, 16, generator=g).to(torch.bfloat16),
                         "ln": torch.ones(2, 8)},
              "head": torch.randn(8, 5, generator=g)}
    assert hub.publish("m", 1, params)
    assert not hub.publish("m", 1, params)  # first writer wins
    assert hub.ensure("m", 1, params) and hub.contains("m", 1)
    got = hub.pull("m", 1)
    assert hub.pull("m", 2) is None and hub.pull("other", 1) is None
    for want, have in ((params["blocks"]["w"], got["blocks"]["w"]),
                       (params["blocks"]["ln"], got["blocks"]["ln"]),
                       (params["head"], got["head"])):
        assert isinstance(have, torch.Tensor) and have.dtype == want.dtype
        assert have.shape == want.shape and torch.equal(have, want)
    hub._evict_locked()


def test_params_sig_tells_weights_apart():
    """Equal weights share a signature (f32 or bf16, any copy); different
    weights never do. The reference hashes only the first leaf in JAX's
    order, ``blocks/ln1``, which every seed initialises to ones, so its
    signatures of two seeds collide; the port hashes every leaf."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.llm.serving import _params_sig as j_sig
    from ray_tpu.models import transformer as J

    from ray_tpu_torch.llm.serving import _params_sig

    ct = T.ModelConfig(dtype=torch.float32, **SMALL)
    a = T.init_params(ct, torch.Generator().manual_seed(0), "cpu")
    b = T.init_params(ct, torch.Generator().manual_seed(1), "cpu")
    copy = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in a.items()}
    assert _params_sig(ct, a, "llm") == _params_sig(ct, copy, "llm")
    assert _params_sig(ct, a, "llm") != _params_sig(ct, b, "llm")
    assert _params_sig(ct, a, "llm") != _params_sig(ct, None, "llm")
    a16 = T.params_to(a, torch.device("cpu"))
    a16 = {k: ({kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict)
               else v.bfloat16()) for k, v in a16.items()}
    assert _params_sig(ct, a16, "llm") == _params_sig(ct, dict(a16), "llm")
    assert _params_sig(ct, a16, "llm") != _params_sig(ct, a, "llm")
    # the reference's signature of two different initialisations
    cj = J.ModelConfig(dtype=jnp.float32, **SMALL)
    pj = [J.init_params(cj, jax.random.PRNGKey(s)) for s in (0, 1)]
    assert j_sig(cj, pj[0], "llm") == j_sig(cj, pj[1], "llm")


def test_a_replica_moves_its_variants_once_and_swaps_to_them():
    """A replica moves the closure's variants to its engine's device when
    it starts: a swap installs those tensors as they are, with no copy,
    and streams on the variant as the JAX engine fed the same weights."""
    from ray_tpu_torch.llm import GenerationConfig, build_llm_deployment

    _, _, ct, base = _models(0)
    cj, pj_alt, _, alt = _models(1)
    app = build_llm_deployment(ct, base, engine="continuous", device="cpu",
                               variants={"m1": alt}, base_model_id="m0",
                               name=f"swap-once-{time.monotonic_ns()}", **ENGINE)
    server = app.deployment.func_or_class()
    try:
        held = T.param_leaves(server._variants["m1"])
        assert server.swap_weights({"model": "m1"})["swapped"]
        live = T.param_leaves(server.engine.params)
        assert [x.data_ptr() for x in live] == [x.data_ptr() for x in held]
        eng = server.engine
        ids = eng.stream_ids(eng.tokenizer.encode("swap me"), GenerationConfig(max_new_tokens=12))
        assert [eng.tokenizer.decode([int(t)]) for t in ids] == _jax_stream(cj, pj_alt, "swap me", 12)
    finally:
        if server._hub is not None:
            server._hub._evict_locked()


def test_a_stream_pinned_to_a_model_runs_on_it_across_a_swap():
    """A stream that names its model runs on that model's weights even when
    a swap to another model is asked for between the replica's pin check
    and the stream's admission: the engine admits a queued request on the
    new weights, so a running stream holds the swap off until it ends (the
    online-RL soak's "epochs mixed mid-stream" on the card, where a publish
    swaps a replica while it streams). Here the submit is held up to 1 s
    while a swap to m1 is asked for; the version before the gate streamed
    on m1."""
    import threading

    from ray_tpu_torch.llm import build_llm_deployment

    _, _, ct, base = _models(0)
    _, _, _, alt = _models(1)
    app = build_llm_deployment(ct, base, engine="continuous", device="cpu",
                               variants={"m1": alt}, base_model_id="m0",
                               name=f"pin-{time.monotonic_ns()}", **ENGINE)
    server = app.deployment.func_or_class()
    request = {"prompt": "pin me", "max_new_tokens": 8, "model": "m0"}
    try:
        want = list(server.stream_tokens(request))
        eng = server.engine
        in_submit, swapped = threading.Event(), threading.Event()
        submit = eng.submit

        def held_submit(prompt, gen):
            in_submit.set()
            swapped.wait(1.0)
            return submit(prompt, gen)

        def swap():
            in_submit.wait(30.0)
            server.swap_weights({"model": "m1"})
            swapped.set()

        eng.submit = held_submit
        th = threading.Thread(target=swap)
        th.start()
        got = list(server.stream_tokens(request))
        th.join(timeout=60.0)
        assert not th.is_alive() and swapped.is_set()
        assert got == want
        assert server.engine.model_id == "m1"  # the swap landed after the stream
    finally:
        if server._hub is not None:
            server._hub._evict_locked()

def test_a_replica_without_a_card_raises():
    """The replicas' default device is the card: without one a replica
    raises, as ``_device.resolve_device`` does, and never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; tests/test_torch_cuda_serve.py covers it")
    from ray_tpu_torch.llm import build_llm_deployment

    app = build_llm_deployment(T.ModelConfig(dtype=torch.float32, **SMALL),
                               engine="continuous", **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.deployment.func_or_class()
