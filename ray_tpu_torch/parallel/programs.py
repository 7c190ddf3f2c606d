"""Rank programs that run one sharded op on a mesh, for parity checks.

Each ``*_case`` function builds its mesh, takes this rank's shard of full
numpy inputs, runs the op (forward and, where it has one, a backward of
``sum(out * cot)``) and gathers the results back to the full layout, so
the caller can hold them against the JAX package's on the same inputs.
``run_cases`` runs a list of them on one launch (``parallel/launch.py``),
so checks that share a world size share the processes' start-up. The
programs live in the port so a rank imports neither a test module nor JAX.
A ``ValueError`` that the op raises is returned as its message.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike
from ..models import moe as moe_mod
from ..models import transformer as tfm
from ..ops.pipeline import pipeline_apply
from ..ops.ring_attention import ring_attention
from ..ops.ulysses import ulysses_attention
from .collectives import all_reduce, gather
from .dryrun import train_rank
from .mesh import MeshConfig, build_mesh, local_shard

Case = Tuple[str, Callable[..., Any], Dict[str, Any]]


def run_cases(cases: Sequence[Case], device: DeviceLike = None) -> Dict[str, Any]:
    """Rank program: ``{name: fn(device=device, **kwargs)}`` for each case."""
    out = {}
    for name, fn, kwargs in cases:
        try:
            out[name] = fn(device=device, **kwargs)
        except ValueError as e:
            out[name] = str(e)
    return out


def _on(mesh, a: np.ndarray, *spec) -> torch.Tensor:
    """This rank's block of ``a`` on the mesh's device."""
    return local_shard(mesh, torch.from_numpy(a), *spec).to(mesh.device)


def _leaf(mesh, a: np.ndarray, *spec) -> torch.Tensor:
    return _on(mesh, a, *spec).clone().requires_grad_()


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def attention_case(device: str, kind: str, sp: int, causal: bool, q: np.ndarray,
                   k: np.ndarray, v: np.ndarray, cot: np.ndarray) -> Dict[str, np.ndarray]:
    """Ring or Ulysses attention over ``sp`` ranks, the sequence (dim 1)
    sharded: the output and the gradients of q, k and v."""
    mesh = build_mesh(MeshConfig(sp=sp), device)
    q_, k_, v_ = (_leaf(mesh, a, None, "sp") for a in (q, k, v))
    fn = ulysses_attention if kind == "ulysses" else ring_attention
    out = fn(q_, k_, v_, mesh, causal=causal)
    (out * _on(mesh, cot, None, "sp")).sum().backward()
    return {name: _np(gather(x, mesh, "sp", 1)) for name, x in
            (("out", out.detach()), ("dq", q_.grad), ("dk", k_.grad), ("dv", v_.grad))}


def tanh_stage(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """A stage of ``tanh(x @ w + b)`` layers (its slice of the stack)."""
    for w, b in zip(p["w"], p["b"]):
        x = torch.tanh(x @ w + b)
    return x


def pipeline_case(device: str, pp: int, w: np.ndarray, b: np.ndarray, x: np.ndarray,
                  cot: np.ndarray) -> Dict[str, np.ndarray]:
    """``pipeline_apply`` of ``tanh_stage`` over ``pp`` ranks, the layer
    stack [L, ...] sharded over ``pp``, x [M, mb, D] the same everywhere:
    the output and the gradients of w, b and x."""
    mesh = build_mesh(MeshConfig(pp=pp), device)
    params = {"w": _leaf(mesh, w, "pp"), "b": _leaf(mesh, b, "pp")}
    x_ = _leaf(mesh, x)
    out = pipeline_apply(tanh_stage, params, x_, mesh)
    (out * _on(mesh, cot)).sum().backward()
    return dict(out=_np(out), dw=_np(gather(params["w"].grad, mesh, "pp", 0)),
                db=_np(gather(params["b"].grad, mesh, "pp", 0)),
                dx=_np(all_reduce(x_.grad, mesh, "pp")))


def moe_case(device: str, dp: int, tp: int, params: Dict[str, np.ndarray], x: np.ndarray,
             cot: np.ndarray, capacity_factor: float) -> Dict[str, Any]:
    """``moe_apply`` of one layer with the batch over ``dp`` (routing over
    the whole batch) and the experts over ``tp``: the output and the
    gradients of x and of every parameter."""
    mesh = build_mesh(MeshConfig(dp=dp, tp=tp), device)
    specs = {k: s[1:] for k, s in moe_mod.moe_specs(None).items()}  # one layer
    p = {k: _leaf(mesh, a, *specs[k]) for k, a in params.items()}
    x_ = _leaf(mesh, x, "dp")
    out = moe_mod.moe_apply(p, x_, capacity_factor, mesh, "dp")
    (out * _on(mesh, cot, "dp")).sum().backward()
    grads = {}
    for k, spec in specs.items():
        g = all_reduce(p[k].grad, mesh, "dp")  # the loss sums over the dp ranks' rows
        for dim, axis in enumerate(spec):
            if axis is not None:
                g = gather(g, mesh, axis, dim)
        grads[k] = _np(g)
    return dict(out=_np(gather(out.detach(), mesh, "dp", 0)),
                dx=_np(gather(x_.grad, mesh, "dp", 0)), grads=grads)


def forward_case(device: str, mesh_config: MeshConfig, cfg: tfm.ModelConfig,
                 params: Dict[str, Any], tokens: np.ndarray, num_microbatches: int = 0
                 ) -> np.ndarray:
    """``forward`` on the mesh from the full parameters and tokens: the
    logits of the whole batch."""
    mesh = build_mesh(mesh_config, device)
    p = tfm.shard_params(tfm.params_from_jax(params, "cpu"), cfg, mesh)
    tok = _on(mesh, tokens.astype(np.int64), "dp", None)
    with torch.no_grad():
        logits = tfm.forward(p, tok, cfg, mesh, num_microbatches=num_microbatches)
    return _np(gather(logits, mesh, "dp", 0))


def train_sgd(runs: Sequence[Any], params: Sequence[Any], tokens: Sequence[np.ndarray],
              device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Two ``torch.optim.SGD(lr=0.1)`` steps of each dry run from the given
    parameters and tokens, with the first step's gradients (rank 0)."""
    return train_rank(runs, device, "sgd", 0.1, 2, params, tokens, grads=True)
