"""LLM serving: engine replicas behind ray_tpu_torch.serve.

Port of ``ray_tpu/llm/serving.py``. The differences:

- ``build_llm_deployment`` takes ``device`` (default: the card) and
  passes it to every engine it builds; a replica without a card raises,
  as ``_device.resolve_device`` does, and never falls back to the CPU;
- ``params`` and ``variants`` ride in the deployment's closure as host
  tensors, and each replica moves them to its own device once, so no
  replica is tied to the driver's CUDA context;
- ``_params_sig`` hashes a slice of every leaf in JAX's leaf order
  (``train/pytree.py``), bf16 as its ``uint16`` bits: the reference hashes
  only the first leaf, ``blocks/ln1``, which every seed initialises to
  ones, so two random initialisations shared one prefix-cache namespace.

Analog of the reference's serve-side LLM deployments: build_llm_deployment
returns a Serve application whose replicas each hold an engine; requests
are {"prompt": str, "max_new_tokens"?: int, "temperature"?: float}.

Serving-plane integration:

- replicas of a ``continuous`` deployment share prefilled KV through
  the node's shm arena (:mod:`ray_tpu_torch.serve.prefix_cache`) — a repeated
  prompt prefix is a pinned read-only view copy-in, not a prefill;
- streams are **resumable**: generation is per-request deterministic
  (seeded), so ``stream_to`` honors ``resume_from=n`` by regenerating
  and skipping the first ``n`` tokens — the router uses this to fail a
  stream over to another replica mid-flight with no duplicated or lost
  acked tokens. Caveat: exactness assumes the resumed replica computes
  the same logits as the original. The cache-hit suffix-prefill program
  and the full prefill differ in reduction shape, so their logits can
  differ in the last ulps; if the original and failover replicas take
  DIFFERENT prefill paths AND a sampled/argmaxed token sits within float
  epsilon of a tie, the resumed trajectory can diverge;
- replicas report engine + prefix-cache stats to their node agent
  (DebugState ``serve`` block) and expose ``serve_stats`` to the
  router's head reporter (QueryState("serve")).
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch

import ray_tpu_torch
import ray_tpu_torch.serve as serve
from .._device import DeviceLike
from ..models.transformer import params_to
from .engine import GenerationConfig, LLMEngine


def _leaf_bytes(leaf: Any) -> Tuple[str, bytes]:
    """(shape, the first 256 elements' bytes) of one leaf on the host, a
    bf16 tensor as its ``uint16`` bits."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        head = leaf.detach().reshape(-1)[:256].cpu()
        if head.dtype == torch.bfloat16:
            head = head.view(torch.int16)
        return str(tuple(leaf.shape)), head.numpy().tobytes()
    a = np.asarray(leaf)
    return str(a.shape), a.ravel()[:256].tobytes()


def _params_sig(model_config: Any, params: Optional[Any], name: str) -> str:
    """Cheap weight signature for the shared prefix cache: KV computed
    under different weights must never collide. Hashes the config repr
    plus the shape and a slice of every parameter leaf (or the
    default-init marker when params is None)."""
    from ray_tpu_torch.train.pytree import leaves as tree_leaves

    h = hashlib.sha256(f"{name}:{model_config}".encode())
    if params is None:
        h.update(b"default-init-seed0")
    else:
        leaves = tree_leaves(params)
        h.update(str(len(leaves)).encode())
        for leaf in leaves:
            shape, head = _leaf_bytes(leaf)
            h.update(shape.encode())
            h.update(head)
    return h.hexdigest()[:24]


def _host(tree: Any) -> Any:
    """A parameter tree with every tensor on the host (None stays None)."""
    if tree is None:
        return None
    return params_to(tree, torch.device("cpu"))


def _kernel_launches(reset: bool) -> dict:
    """This process's launches of the hand-written kernels the engines
    reach (the paged decode kernel; the flash forward through ``forward``),
    counted where each wrapper launches its kernel; ``reset`` zeroes them
    after the read."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode

    out = {"paged_attention_decode": paged_attention_decode.launches,
           "flash_attention_fwd": flash_attention_forward.launches}
    if reset:
        paged_attention_decode.launches = flash_attention_forward.launches = 0
    return out


def _gen_from_request(request) -> GenerationConfig:
    return GenerationConfig(
        max_new_tokens=int(request.get("max_new_tokens", 32)),
        temperature=float(request.get("temperature", 0.0)),
        seed=int(request.get("seed", 0)),
    )


class _ModelGate:
    """Requests hold the replica's weights shared while they run; a swap
    holds them alone. The engine is stepped by the thread that streams a
    request, and ``swap_params`` drains the active slots by stepping it
    from the swapping thread, so a swap beside a running stream would step
    the engine from two threads at once; and the engine admits a queued
    request on whatever weights it holds when a slot opens, so a swap that
    lands between a request's pin check and its admission would run it on
    another model. A waiting swap keeps new requests out (it goes first)
    and waits at most ``cfg.serve_swap_drain_deadline_s`` (0: without
    bound) for those running, the engine's own drain deadline."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._alone = False
        self._waiting = 0
        # swaps that waited for running requests: the longest wait, and
        # how many gave up at the deadline
        self.wait_ms_max = 0.0
        self.deadline_misses = 0

    def acquire_shared(self) -> None:
        with self._cv:
            while self._alone or self._waiting:
                self._cv.wait()
            self._shared += 1

    def release_shared(self) -> None:
        with self._cv:
            self._shared -= 1
            self._cv.notify_all()

    @contextmanager
    def alone(self):
        from ..config import cfg

        limit = float(cfg.serve_swap_drain_deadline_s)
        deadline = time.monotonic() + limit if limit > 0 else None
        t0 = time.monotonic()
        with self._cv:
            self._waiting += 1
            try:
                while self._alone or self._shared:
                    left = None if deadline is None else deadline - time.monotonic()
                    if left is not None and left <= 0 and not self._alone:
                        self.deadline_misses += 1
                        break  # past the deadline: the engine's drain takes over
                    self._cv.wait(left)
            finally:
                self._waiting -= 1
            self._alone = True
            self.wait_ms_max = max(self.wait_ms_max, (time.monotonic() - t0) * 1e3)
        try:
            yield
        finally:
            with self._cv:
                self._alone = False
                self._cv.notify_all()


def build_llm_deployment(
    model_config: Any,
    params: Optional[Any] = None,
    *,
    name: str = "llm",
    num_replicas: int = 1,
    max_len: int = 256,
    engine: str = "dense",  # "dense" | "continuous" (paged KV)
    max_batch: int = 8,
    page_size: int = 16,
    n_pages: int = 256,
    prefix_cache: bool = True,
    slo: Optional[Any] = None,
    # disaggregated serving: >0 stands up a companion
    # "<name>-prefill" deployment — the router runs the prefill phase
    # there, KV pages ship to these (now decode-only) replicas as
    # sealed device frames, and decode scales independently
    prefill_replicas: int = 0,
    # model multiplexing: extra weight pytrees replicas hot-swap
    # between ({model_id: params}); the base weights are model id
    # ``base_model_id``
    variants: Optional[Dict[str, Any]] = None,
    base_model_id: str = "base",
    device: DeviceLike = None,
    tokenizer: Optional[Any] = None,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """A Serve application of ``num_replicas`` engine replicas of
    ``model_config`` with ``params`` (default: the engine's seed-0 init),
    each on ``device`` (default: the card). ``tokenizer`` (default: the
    engines' byte tokenizer) and ``ray_actor_options`` (e.g. a GPU lease,
    ``{"num_gpus": 0.5}``) apply to every replica, the prefill fleet's
    too."""
    if engine not in ("dense", "continuous"):
        raise ValueError(
            f"unknown engine {engine!r}; expected 'dense' or 'continuous'"
        )
    if (prefill_replicas or variants) and engine != "continuous":
        raise ValueError(
            "prefill/decode disaggregation and model multiplexing "
            "require engine='continuous' (paged KV)"
        )
    model_sig = _params_sig(model_config, params, name)
    params = _host(params)
    variants = {k: _host(v) for k, v in variants.items()} if variants else None
    models = (
        [base_model_id, *variants] if variants else None
    )

    def _make_engine(model_id: str):
        from .continuous import ContinuousBatchingEngine

        cache = None
        if prefix_cache:
            from ray_tpu_torch.serve.prefix_cache import cache_from_cfg

            cache = cache_from_cfg(
                page_size=page_size, model_sig=model_sig
            )
        return ContinuousBatchingEngine(
            model_config,
            params,
            max_batch=max_batch,
            page_size=page_size,
            n_pages=n_pages,
            prefix_cache=cache,
            model_id=model_id,
            device=device,
            tokenizer=tokenizer,
        )

    prefill_dep_name = f"{name}-prefill" if prefill_replicas else None

    @serve.deployment(
        name=name,
        num_replicas=num_replicas,
        # continuous-engine generation is per-request deterministic
        # (seeded sampling), so streams can fail over mid-flight
        resumable_streams=(engine == "continuous"),
        stats_method="serve_stats",
        slo=slo,
        prefill_deployment=prefill_dep_name,
        models=models,
        ray_actor_options=dict(ray_actor_options or {}),
    )
    class LLMServer:
        def __init__(self):
            if engine == "continuous":
                self.engine = _make_engine(base_model_id)
            else:
                self.engine = LLMEngine(model_config, params, max_len=max_len,
                                        tokenizer=tokenizer, device=device)
            self._tokens_out = 0
            # hot-swap plane: base + variant weights by model id, moved
            # to the engine's device once (a swap then copies nothing, and
            # a publish seals CUDA leaves as device frames); the node
            # WeightsHub (shm arena) is probed first so same-node siblings
            # pull sealed device frames instead of re-reading the closure
            # capture
            self._variants = {k: params_to(v, self.engine.device)
                              for k, v in (variants or {}).items()}
            self._variants[base_model_id] = getattr(
                self.engine, "params", params
            )
            self._hub = None
            if variants:
                from ray_tpu_torch.serve.model_store import hub_from_node

                self._hub = hub_from_node(name)
            self._swap_lock = threading.Lock()
            self._gate = _ModelGate()
            self._swap_done_t: Optional[float] = None
            self._swaps = 0
            self._ft_new_count = 0
            self._ft_new_ms_sum = 0.0
            # KV handoff accounting (kv_handoff_mb_per_s)
            self._handoff_bytes = 0
            self._handoff_s = 0.0
            self._handoffs = 0
            self._handoff_fallbacks = 0
            self._start_agent_reporter()

        # -- model multiplexing ------------------------------------------
        @contextmanager
        def _on_model(self, request):
            """Runs the body on the model ``request`` names (none: on what
            the engine holds), with swaps held off until it ends."""
            if not hasattr(self.engine, "swap_params"):
                yield
                return
            model = request.get("model") if isinstance(request, dict) else None
            while True:
                self._ensure_model(request)
                self._gate.acquire_shared()
                if not model or self.engine.model_id == model:
                    break
                self._gate.release_shared()
            try:
                yield
            finally:
                self._gate.release_shared()

        def _ensure_model(self, request) -> None:
            model = (
                request.get("model") if isinstance(request, dict) else None
            )
            if (
                model
                and hasattr(self.engine, "swap_params")
                and model != self.engine.model_id
            ):
                self.swap_weights({"model": model})

        def swap_weights(self, request) -> dict:
            """Admin/routing-triggered weights hot-swap: drain in-flight
            generation on the old weights-epoch, install the new model's
            params (WeightsHub device-frame pull when published, closure
            variant fallback), bump the epoch. Zero stream errors by
            construction — active slots finish before the swap lands."""
            from ray_tpu_torch.serve import model_store as ms

            model = request["model"]
            version = int(request.get("version", 0))
            with self._swap_lock:
                if model == self.engine.model_id:
                    return {
                        "model": model,
                        "epoch": self.engine.weights_epoch,
                        "swapped": False,
                    }
                labels = {"deployment": name, "model": str(model)}
                t0 = time.monotonic()
                new_params = None
                if self._hub is not None:
                    new_params = self._hub.pull(model, version, self.engine.device)
                if new_params is None:
                    if model not in self._variants:
                        ms.WEIGHT_SWAP_FAILURES.inc(labels=labels)
                        raise ValueError(
                            f"unknown model {model!r} for deployment "
                            f"{name!r} (known: {sorted(self._variants)})"
                        )
                    new_params = self._variants[model]
                    if self._hub is not None:
                        # publish for same-node siblings: their pull
                        # lands device frames straight from the arena
                        self._hub.publish(model, version, new_params)
                t_drain = time.monotonic()
                with self._gate.alone():
                    epoch = self.engine.swap_params(new_params, model_id=model)
                now = time.monotonic()
                ms.WEIGHT_SWAP_DRAIN_MS.observe(
                    (now - t_drain) * 1000.0, labels=labels
                )
                ms.WEIGHT_SWAP_MS.observe(
                    (now - t0) * 1000.0, labels=labels
                )
                ms.WEIGHT_SWAPS.inc(labels=labels)
                self._swap_done_t = now
                self._swaps += 1
                return {"model": model, "epoch": epoch, "swapped": True}

        def _note_first_token(self) -> None:
            """First token generated after a swap: export the
            first-token-on-new-weights latency exactly once."""
            if self._swap_done_t is None:
                return
            from ray_tpu_torch.serve import model_store as ms

            t, self._swap_done_t = self._swap_done_t, None
            ft_ms = (time.monotonic() - t) * 1000.0
            ms.FIRST_TOKEN_NEW_WEIGHTS_MS.observe(
                ft_ms,
                labels={
                    "deployment": name,
                    "model": str(self.engine.model_id),
                },
            )
            # instance-level mirror of the histogram: metrics are
            # per-process, so a driver (another process) reads
            # these through serve_stats instead
            self._ft_new_count += 1
            self._ft_new_ms_sum += ft_ms

        # -- KV handoff (decode side) ------------------------------------
        def _adopt_handoff(self, handoff) -> Optional[int]:
            """Pull the prefill worker's sealed KV pages over the data
            plane (device landing when the plane is on) and graft them
            into the engine. Returns the adopted req_id, or None on ANY
            failure — prefill death mid-handoff, model mismatch, pool
            backpressure — in which case the caller re-prefills locally
            (token-exact: generation is seed-deterministic)."""
            from ray_tpu_torch.cluster import device_plane as _dp

            t0 = time.monotonic()
            try:
                ref = handoff[0]
                if _dp.device_plane_enabled():
                    with _dp.landing("device"):
                        manifest, k, v = ray_tpu_torch.get(ref, timeout=30.0)
                else:
                    manifest, k, v = ray_tpu_torch.get(ref, timeout=30.0)
                rid = self.engine.adopt_pages(manifest, k, v)
            except Exception:  # noqa: BLE001
                self._handoff_fallbacks += 1
                return None
            if rid is None:
                self._handoff_fallbacks += 1
                return None
            self._handoff_bytes += int(k.nbytes) + int(v.nbytes)
            self._handoff_s += time.monotonic() - t0
            self._handoffs += 1
            return rid

        # -- request surface ---------------------------------------------
        def __call__(self, request):
            prompt = request["prompt"]
            gen = _gen_from_request(request)
            with self._on_model(request):
                text = self.engine.generate([prompt], gen)[0]
            self._note_first_token()
            return {"prompt": prompt, "generated_text": text}

        def stream_tokens(self, request):
            """Generator-based token streaming: call with
            ``.options(num_returns="streaming")`` and iterate the
            ObjectRefGenerator — each decoded token text seals as its own
            object with normal object-plane semantics."""
            if not hasattr(self.engine, "stream_ids"):
                raise TypeError(
                    "token streaming requires engine='continuous'"
                )
            gen = _gen_from_request(request)
            prompt = self.engine.tokenizer.encode(request["prompt"])
            with self._on_model(request):
                for tok in self.engine.stream_ids(prompt, gen):
                    self._note_first_token()
                    yield self.engine.tokenizer.decode([int(tok)])

        def stream_to(self, writer, request):
            """Router/ingress streaming contract: decoded token text
            through a ChannelWriter-compatible handle (shm ring same-host,
            PushWriter cross-host, relay actor legacy). ``resume_from=n``
            regenerates deterministically and skips the first n tokens —
            the router's mid-stream failover path."""
            if not hasattr(self.engine, "stream_ids"):
                writer.write("streaming requires engine='continuous'")
                writer.close_channel()
                return 0
            gen = _gen_from_request(request)
            skip = max(0, int(request.get("resume_from", 0)))
            prompt = self.engine.tokenizer.encode(request["prompt"])
            n = 0
            with self._on_model(request):
                # disaggregated handoff: graft the prefill worker's KV pages
                # and stream from the adopted slot — no local prefill. Any
                # handoff failure falls through to stream_ids (local
                # re-prefill), the same path a resume_from failover takes.
                rid = None
                handoff = (
                    request.get("handoff")
                    if isinstance(request, dict)
                    else None
                )
                if handoff and not skip and hasattr(self.engine, "adopt_pages"):
                    rid = self._adopt_handoff(handoff)
                tokens = (
                    self.engine.stream_rid(rid)
                    if rid is not None
                    else self.engine.stream_ids(prompt, gen)
                )
                for tok in tokens:
                    self._note_first_token()
                    if n >= skip:
                        writer.write(self.engine.tokenizer.decode([int(tok)]))
                    n += 1
                    self._tokens_out += 1
            writer.close_channel()
            return n

        # -- online-RL hot-swap ---------------------------------------------
        def swap_weights_ref(self, request) -> dict:
            """Install params shipped through the OBJECT PLANE — the
            online-RL publish path, where the weights are genuinely new
            (trained this run) rather than a pre-built variant. The tree
            lands from the ref, is registered as a variant (so
            ``_ensure_model`` routing and replica restarts resolve the
            model id), pushed into the node hub for same-node siblings,
            then installed under the usual epoch-fenced drain."""
            from ray_tpu_torch.serve import model_store as ms

            model = request["model"]
            version = int(request.get("version", 0))
            new_params = params_to(
                ray_tpu_torch.get(request["params_ref"], timeout=60.0),
                self.engine.device,
            )
            with self._swap_lock:
                if model == self.engine.model_id:
                    return {
                        "model": model,
                        "epoch": self.engine.weights_epoch,
                        "swapped": False,
                    }
                labels = {"deployment": name, "model": str(model)}
                t0 = time.monotonic()
                self._variants[model] = new_params
                if self._hub is not None:
                    self._hub.ensure(model, version, new_params)
                with self._gate.alone():
                    epoch = self.engine.swap_params(new_params, model_id=model)
                now = time.monotonic()
                ms.WEIGHT_SWAP_MS.observe(
                    (now - t0) * 1000.0, labels=labels
                )
                ms.WEIGHT_SWAPS.inc(labels=labels)
                self._swap_done_t = now
                self._swaps += 1
                return {"model": model, "epoch": epoch, "swapped": True}

        # -- observability -----------------------------------------------
        def pid(self) -> int:
            return os.getpid()

        def kernel_launches(self, reset: bool = False) -> dict:
            return _kernel_launches(reset)

        def serve_stats(self) -> dict:
            stats = (
                self.engine.stats()
                if hasattr(self.engine, "stats")
                else {}
            )
            return {
                "pid": os.getpid(),
                "tokens_out": self._tokens_out,
                "weight_swaps": self._swaps,
                "first_token_new_weights_count": self._ft_new_count,
                "first_token_new_weights_ms_sum": round(
                    self._ft_new_ms_sum, 3
                ),
                "swap_gate_wait_ms_max": round(self._gate.wait_ms_max, 3),
                "swap_gate_deadline_misses": self._gate.deadline_misses,
                "handoffs": self._handoffs,
                "handoff_fallbacks": self._handoff_fallbacks,
                "handoff_bytes": self._handoff_bytes,
                "handoff_s": round(self._handoff_s, 6),
                "kv_handoff_mb_per_s": (
                    round(
                        self._handoff_bytes / self._handoff_s / (1 << 20), 2
                    )
                    if self._handoff_s > 0
                    else None
                ),
                **stats,
            }

        def _start_agent_reporter(self) -> None:
            """Inside a cluster worker: push engine/prefix stats to the
            node agent so its DebugState grows a ``serve`` block (node-
            local control-plane traffic, never the head)."""
            from ray_tpu_torch.cluster import worker as worker_mod

            w = getattr(worker_mod, "_CURRENT_WORKER", None)
            if w is None or not hasattr(self.engine, "stats"):
                return
            # weakref: the reporter must not keep a killed replica's
            # engine alive (or the thread running) past the actor's
            # lifetime — a strong capture leaked the whole KV pool per
            # replica churn and blocked worker scrub/reuse
            import weakref

            ref = weakref.ref(self)

            def loop():
                import time as _time

                from ray_tpu_torch.config import cfg

                while True:
                    _time.sleep(max(0.2, float(cfg.serve_report_period_s)))
                    inst = ref()
                    if inst is None:
                        return  # replica collected: thread retires
                    try:
                        w.agent.call(
                            "ServeStats",
                            {
                                "pid": os.getpid(),
                                "deployment": name,
                                "stats": inst.serve_stats(),
                            },
                            timeout=5.0,
                        )
                    except Exception:  # noqa: BLE001 - agent mid-restart
                        pass
                    del inst

            threading.Thread(
                target=loop, name="serve-stats-report", daemon=True
            ).start()

    if prefill_replicas:
        # the companion prefill fleet: runs the bucketed prefill
        # program, seals the KV pages + manifest as its task result
        # (device frames when the plane is on), never decodes. Deployed
        # EAGERLY here so the decode router's prefill orchestration
        # finds it registered the moment the decode app runs.
        @serve.deployment(
            name=prefill_dep_name,
            num_replicas=prefill_replicas,
            stats_method="serve_stats",
            models=models,
            ray_actor_options=dict(ray_actor_options or {}),
        )
        class PrefillServer:
            def __init__(self):
                self.engine = _make_engine(base_model_id)
                self._variants = {k: params_to(v, self.engine.device)
                                  for k, v in (variants or {}).items()}
                self._variants[base_model_id] = self.engine.params
                self._swap_lock = threading.Lock()

            def prefill(self, request):
                """One prefill phase: returns ``(manifest, k, v)`` — the
                sealed KV pages for the prompt plus the page-table
                manifest (first token included; it is sampled from the
                same deterministic per-request key stream decode uses)."""
                model = (
                    request.get("model")
                    if isinstance(request, dict)
                    else None
                )
                if model and model != self.engine.model_id:
                    with self._swap_lock:
                        if model != self.engine.model_id:
                            new_params = self._variants.get(model)
                            if new_params is None:
                                raise ValueError(
                                    f"unknown model {model!r} for "
                                    f"prefill fleet {prefill_dep_name!r}"
                                )
                            self.engine.swap_params(
                                new_params, model_id=model
                            )
                gen = _gen_from_request(request)
                prompt = self.engine.tokenizer.encode(request["prompt"])
                return self.engine.prefill_extract(prompt, gen)

            def pid(self) -> int:
                return os.getpid()

            def kernel_launches(self, reset: bool = False) -> dict:
                return _kernel_launches(reset)

            def serve_stats(self) -> dict:
                return {
                    "pid": os.getpid(),
                    "role": "prefill",
                    **self.engine.stats(),
                }

        serve.run(PrefillServer.bind())

    return LLMServer.bind()
