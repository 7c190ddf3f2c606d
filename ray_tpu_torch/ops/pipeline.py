"""Pipeline parallelism: the GPipe schedule over the mesh's ``pp`` axis.

Port of ``ray_tpu/ops/pipeline.py``. Each ``pp`` rank holds one stage's
parameters; M microbatches pass through S stages in M + S - 1 ticks. At
tick t stage 0 takes microbatch ``min(t, M-1)``, every other stage takes
what its predecessor sent at t - 1 (a non-cyclic ``ppermute``), and the
last stage banks its output as microbatch ``clip(t-(S-1), 0, M-1)``.
Then a ``psum`` over ``pp`` of the last stage's outputs gives every rank
all M outputs, so the code after the pipeline is the same on every rank.

JAX differentiates the schedule by transposing the ``ppermute``s. In torch
a stage's graph never reaches its neighbours', so the schedule is one
``autograd.Function`` whose backward runs the ticks in reverse: each stage
back-propagates each microbatch through the graph kept from the forward
(``torch.autograd.grad``), sends the input's gradient to its predecessor
and receives its output's gradient from its successor. Every rank makes
the same collective calls in the same order, forward and backward. A stage
skips the ticks whose result no stage uses (before its first microbatch
arrives, after its last has left), where the reference computes and
discards; the outputs are the same.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..parallel.collectives import all_reduce, permute
from ..parallel.mesh import Mesh


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]], Any]]:
    """The tensors of a nested dict in sorted-key order, and the inverse."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    keys = sorted(tree)
    parts = [_flatten(tree[k]) for k in keys]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = {}, 0
        for k, (_, sub), n in zip(keys, parts, sizes):
            out[k] = sub(leaves[i:i + n])
            i += n
        return out

    return [x for p in parts for x in p[0]], rebuild


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, mesh, axis, rebuild, keep_graph, x, *leaves):
        n_stages, stage = mesh.size(axis), mesh.index(axis)
        m = x.shape[0]
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        stage_params = rebuild(params)
        fwd = [(i, i + 1) for i in range(n_stages - 1)]
        ticks: List[Any] = []
        outputs = torch.zeros_like(x)
        recv = torch.zeros_like(x[0])
        n_ticks = m + n_stages - 1
        for t in range(n_ticks):
            if stage <= t < stage + m:  # this stage holds microbatch t - stage
                inp = (x[t] if stage == 0 else recv).detach().requires_grad_(keep_graph)
                with torch.set_grad_enabled(keep_graph):
                    out = stage_fn(stage_params, inp)
                ticks.append((inp, out))
                out = out.detach()
                if stage == n_stages - 1:
                    outputs[t - stage] = out
            else:
                out = torch.zeros_like(recv)
                ticks.append(None)
            if t < n_ticks - 1:  # the last tick's hand-off has no receiver
                recv = permute(out, mesh, axis, fwd)
        ctx.mesh, ctx.axis, ctx.ticks, ctx.params, ctx.x_shape = mesh, axis, ticks, params, x.shape
        return all_reduce(outputs, mesh, axis)

    @staticmethod
    def backward(ctx, d_outputs):
        mesh, axis, ticks, params = ctx.mesh, ctx.axis, ctx.ticks, ctx.params
        n_stages, stage = mesh.size(axis), mesh.index(axis)
        bwd = [(i + 1, i) for i in range(n_stages - 1)]
        trainable = [p for p in params if p.requires_grad]
        d_params = [torch.zeros_like(p) for p in trainable]
        dx = torch.zeros(ctx.x_shape, dtype=d_outputs.dtype, device=d_outputs.device)
        d_inp = None
        n_ticks = len(ticks)
        for t in reversed(range(n_ticks)):
            if t < n_ticks - 1:
                d_out = permute(d_inp, mesh, axis, bwd)
            if stage == n_stages - 1 and ticks[t] is not None:
                d_out = d_outputs[t - stage]
            if ticks[t] is None:
                d_inp = torch.zeros(ctx.x_shape[1:], dtype=dx.dtype, device=dx.device)
                continue
            inp, out = ticks[t]
            grads = torch.autograd.grad(out, [inp] + trainable, d_out, allow_unused=True)
            d_inp = grads[0] if grads[0] is not None else torch.zeros_like(inp)
            for acc, g in zip(d_params, grads[1:]):
                if g is not None:
                    acc += g
            if stage == 0:
                dx[t] = d_inp
        ctx.ticks = None
        it = iter(d_params)
        return (None, None, None, None, None, dx) + tuple(
            next(it) if p.requires_grad else None for p in params)


def pipeline_apply(stage_fn: Callable[[Dict[str, Any], torch.Tensor], torch.Tensor],
                   stage_params: Dict[str, Any], x: torch.Tensor, mesh: Mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run x through every pipeline stage. ``stage_fn(stage_params, x_mb)``
    is this rank's stage and keeps the microbatch's shape; ``stage_params``
    is a (nested) dict of this stage's tensors; x: [M, mb, ...], all
    microbatches, the same on every ``pp`` rank. Returns [M, mb, ...], the
    last stage's outputs, on every rank. Differentiable in x (the gradient
    reaches x on stage 0 only, the stage that reads it) and in the stage
    parameters."""
    leaves, rebuild = _flatten(stage_params)
    keep_graph = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in leaves))
    return _Pipeline.apply(stage_fn, mesh, axis, rebuild, keep_graph, x, *leaves)
