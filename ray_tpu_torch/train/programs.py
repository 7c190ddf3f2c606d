"""The flagship transformer as an elastic training program.

``lm_init`` and ``lm_step`` are an ``ElasticTrainer``'s ``init_fn`` and
``step_fn`` for ``models/transformer.py``'s model: each virtual shard the
rank owns trains on its own microbatch, made from ``(seed, step, shard)``
with a seeded generator, and its gradients, loss and flash kernel
launches are that shard's partial, moved to the host so a rendezvous hub
without a card can hold it; ``gang.allreduce_shards`` sums the partials of
all shards in ascending shard order, and every rank applies the same Adam update, written
as ``optax.adam`` computes it (moments in the parameters' dtype, bias
corrections from the step count). The state is ``{"params", "opt": {"m",
"v", "t"}}``, every leaf a tensor on the rank's device, so a seal carries
it as device frames.

``lm_reference`` runs the same steps in one process over every shard (a
gang of one that owns the whole grid): the summation tree and the update
are the same, so an elastic run that shrinks and grows lands on its
parameters, moments and losses bit for bit. The programs live in the port
so a cluster worker unpickles them by import path.

``config`` keys: ``model`` (``ModelConfig`` keyword arguments, ``dtype``
as a name), ``device``, ``seed``, ``batch``, ``seq`` and ``lr``.
"""
from __future__ import annotations

import operator
import time
from functools import reduce
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models import transformer as tfm
from ..ops import flash_attention as flash
from . import pytree

B1, B2, EPS = 0.9, 0.999, 1e-8
KERNELS = ("fwd", "dq", "dkv")


def model_config(config: Dict[str, Any]) -> tfm.ModelConfig:
    kw = dict(config.get("model") or {})
    kw["dtype"] = getattr(torch, kw.get("dtype", "bfloat16"))
    return tfm.ModelConfig(**kw)


def adam_init(params: Any) -> Dict[str, Any]:
    """``optax.adam``'s state for ``params``: zero moments, count 0, on the
    parameters' device."""
    return {
        "m": pytree.tree_map(torch.zeros_like, params),
        "v": pytree.tree_map(torch.zeros_like, params),
        "t": torch.zeros((), dtype=torch.int32, device=pytree.leaves(params)[0].device),
    }


def value_and_grad(fn: Callable, params: Any, has_aux: bool = False) -> Tuple[Any, List]:
    """(``fn(params)``, the gradient of its loss in ``pytree.leaves`` order),
    as ``jax.value_and_grad``: with ``has_aux`` ``fn`` returns ``(loss,
    aux)``. ``params``' own tensors are left untouched."""
    leaves, treedef = pytree.flatten(params)
    ps = [x.detach().requires_grad_() for x in leaves]
    out = fn(pytree.unflatten(treedef, ps))
    return out, list(torch.autograd.grad(out[0] if has_aux else out, ps))


def lm_init(config: Dict[str, Any]) -> Dict[str, Any]:
    cfg = model_config(config)
    dev = torch.device(config.get("device", "cuda"))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(int(config["seed"])), dev)
    return {"params": params, "opt": adam_init(params)}


def lm_tokens(config: Dict[str, Any], step: int, shard: int) -> torch.Tensor:
    """Shard ``shard``'s microbatch at ``step``: the same on every rank
    and every device."""
    rng = np.random.default_rng([int(config["seed"]), int(step), int(shard)])
    vocab = model_config(config).vocab_size
    tok = rng.integers(0, vocab, (int(config["batch"]), int(config["seq"])))
    return torch.from_numpy(tok).to(torch.device(config.get("device", "cuda")))


def shard_partial(state: Dict[str, Any], step: int, shard: int, virtual_shards: int,
                  config: Dict[str, Any]) -> Dict[str, Any]:
    """One shard's gradients and loss at ``state``, and the flash kernel
    launches it made, in row ``shard`` of a ``[virtual_shards, 3]`` count
    (fwd, dq, dkv) that is zero elsewhere: the sum over the shards gives
    each shard's own launches."""
    cfg = model_config(config)
    tokens = lm_tokens(config, step, shard)
    before = launch_counts()
    loss, grads = value_and_grad(lambda p: tfm.loss_fn(p, tokens, cfg), state["params"])
    after = launch_counts()
    launches = torch.zeros((int(virtual_shards), len(KERNELS)), dtype=torch.int64)
    launches[shard] = torch.tensor([after[k] - before[k] for k in KERNELS])
    return {"g": [g.cpu() for g in grads], "loss": loss.detach().cpu(), "launches": launches}


def adam_update(state: Dict[str, Any], grads: List[torch.Tensor],
                lr: float) -> Dict[str, Any]:
    """``optax.adam(lr)`` then ``optax.apply_updates``: moments in the
    parameters' dtype, each op rounded to it, and every Python constant
    first rounded to it too, as JAX's weakly typed scalars are (in bf16,
    0.999 is 1.0); the bias corrections in f32, cast to it."""
    leaves, treedef = pytree.flatten(state["params"])
    ms, vs = pytree.leaves(state["opt"]["m"]), pytree.leaves(state["opt"]["v"])
    t = state["opt"]["t"] + 1
    tf = t.float()
    new_p, new_m, new_v = [], [], []
    for p, m, v, g in zip(leaves, ms, vs, grads):
        g = g.to(p.device)

        def c(x):
            return torch.tensor(x, dtype=p.dtype, device=p.device)

        m = c(1 - B1) * g + c(B1) * m
        v = c(1 - B2) * (g * g) + c(B2) * v
        m_hat = m / (1 - torch.pow(B1, tf)).to(m.dtype)
        v_hat = v / (1 - torch.pow(B2, tf)).to(v.dtype)
        new_p.append(p - c(lr) * (m_hat / (torch.sqrt(v_hat) + c(EPS))))
        new_m.append(m)
        new_v.append(v)
    return {
        "params": pytree.unflatten(treedef, new_p),
        "opt": {"m": pytree.unflatten(treedef, new_m),
                "v": pytree.unflatten(treedef, new_v), "t": t},
    }


def launch_counts() -> Dict[str, int]:
    """This process's flash kernel launches so far."""
    return {"fwd": flash.flash_attention_forward.launches,
            "dq": flash.flash_attention_bwd_dq.launches,
            "dkv": flash.flash_attention_bwd_dkv.launches}


def seal_counts() -> Dict[str, float]:
    """This process's state seals so far: bytes, count and summed ms
    (``ELASTIC_SEAL_BYTES``, ``ELASTIC_SEAL_MS``), and the device frames
    its pickler exported with a copy (``copied_frames``: a CUDA leaf's
    D2H; a contiguous host tensor exports without one)."""
    from ..cluster import device_plane
    from .elastic import ELASTIC_SEAL_BYTES, ELASTIC_SEAL_MS

    ms = ELASTIC_SEAL_MS.summary()
    st = device_plane.device_stats()
    return {"seal_bytes": ELASTIC_SEAL_BYTES.value(), "seals": int(ms["count"]),
            "seal_ms_sum": float(ms["sum"]),
            "copied_frames": st["device_frame_seals_total"] - st["device_frame_zero_copy_total"]}


def lm_step(state: Dict[str, Any], step: int, gang: Any,
            config: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    partials = {v: shard_partial(state, step, v, gang.virtual_shards, config)
                for v in gang.owned_shards()}
    total = gang.allreduce_shards(partials)
    new = adam_update(state, total["g"], float(config["lr"]))
    loss = float(total["loss"]) / gang.virtual_shards
    return new, {"step": step, "world": gang.world, "loss": loss, "wall": time.time(),
                 "device": str(new["params"]["embed"].device),
                 "launches": [dict(zip(KERNELS, row)) for row in total["launches"].tolist()],
                 **seal_counts()}


class OneProcessGang:
    """A gang of one that owns the whole virtual grid and folds the
    partials as ``GangContext.allreduce_shards`` does."""

    world = 1
    rank = 0

    def __init__(self, virtual_shards: int):
        self.virtual_shards = int(virtual_shards)

    def owned_shards(self, step=None) -> List[int]:
        return list(range(self.virtual_shards))

    def allreduce_shards(self, partials: Dict[int, Any]) -> Any:
        ordered = [partials[v] for v in sorted(partials)]
        return pytree.tree_map(lambda *xs: reduce(operator.add, xs), *ordered)


def lm_reference(config: Dict[str, Any], total_steps: int,
                 virtual_shards: int) -> Tuple[Dict[str, Any], List[float]]:
    """The same ``total_steps`` in this process: (final state, losses)."""
    gang = OneProcessGang(virtual_shards)
    state, losses = lm_init(config), []
    for step in range(total_steps):
        state, metrics = lm_step(state, step, gang, config)
        losses.append(metrics["loss"])
    return state, losses
