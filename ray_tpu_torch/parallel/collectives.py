"""In-program collectives over one mesh axis, with JAX's transposes.

The port's counterparts of the ``jax.lax`` collectives that the sharded
ops use inside ``shard_map`` (``psum``, ``all_gather``, ``ppermute``,
``all_to_all``; ``axis_index`` and ``axis_size`` are ``Mesh.index`` and
``Mesh.size``), on the axis's ``torch.distributed`` group (NCCL on the
card, gloo on the CPU). Each
differentiable one is a ``torch.autograd.Function`` whose backward is the
collective JAX transposes it to:

- ``ppermute``: the inverse permutation; a rank that no pair sends to
  receives zeros, as in JAX;
- ``all_to_all``: the reverse swap;
- ``psum`` and ``all_gather`` give a result replicated over the axis. The
  loss computed from it is the same on every rank of the axis and counts
  once, so ``psum``'s backward is the identity and ``all_gather``'s takes
  this rank's slice (Megatron's *g*);
- ``copy_to`` marks a replicated tensor entering rank-local compute:
  the identity forward, a ``psum`` of the gradients backward (Megatron's
  *f*).

On an axis of size 1 every collective returns its input, so a mesh of size
1 runs no communication. Every rank of a group must call the same
collectives in the same order, forward and backward: the ops that use
them are written so that each rank's autograd graph has the same shape.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

Perm = Sequence[Tuple[int, int]]


# --- plain collectives (no autograd) ---------------------------------------

def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over the axis, into a new tensor."""
    if mesh.size(axis) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.groups[axis])
    return out


def gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in axis order."""
    n = mesh.size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.cat(parts, dim)


def permute(x: torch.Tensor, mesh: Mesh, axis: str, perm: Perm) -> torch.Tensor:
    """Send ``x`` along the (source, destination) pairs of ``perm`` (axis
    indices); a rank that no pair sends to gets zeros. Every send and
    receive of the call is posted in one ``batch_isend_irecv``."""
    i = mesh.index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    if mesh.size(axis) == 1:
        return x.clone() if (0, 0) in perm else out
    ranks, group = mesh.ranks(axis), mesh.groups[axis]
    ops = [dist.P2POp(dist.isend, x, ranks[d], group) for s, d in perm if s == i]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s, d in perm if d == i]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def swap(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int
         ) -> torch.Tensor:
    """Tiled all-to-all: split ``x`` along ``split_dim`` into one chunk per
    rank, send chunk j to rank j, and concatenate what arrives along
    ``concat_dim`` in axis order (``jax.lax.all_to_all(..., tiled=True)``).
    ``all_to_all_single`` splits dimension 0, so the chunks move there
    first."""
    n = mesh.size(axis)
    if n == 1:
        return x
    shape = list(x.shape)
    chunk = shape[split_dim] // n
    xs = x.reshape(shape[:split_dim] + [n, chunk] + shape[split_dim + 1:])
    xs = xs.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=mesh.groups[axis])
    out = out.movedim(0, concat_dim)  # [..., n, L, ...]: sender-major along concat_dim
    merged = list(out.shape[:concat_dim]) + [-1] + list(out.shape[concat_dim + 2:])
    return out.reshape(merged)


# --- differentiable collectives ---------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.index(ctx.axis) * ctx.n, ctx.n), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return permute(g, ctx.mesh, ctx.axis, inverse), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return swap(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return swap(g, *ctx.args), None, None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over the axis; the result is replicated (backward: identity)."""
    return x if mesh.size(axis) == 1 else _PSum.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """A replicated tensor entering rank-local compute (backward: psum)."""
    return x if mesh.size(axis) == 1 else _CopyTo.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim``; the result is replicated (backward:
    this rank's slice)."""
    return x if mesh.size(axis) == 1 else _AllGather.apply(x, mesh, axis, dim)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm: Perm) -> torch.Tensor:
    """``jax.lax.ppermute`` (backward: the inverse permutation)."""
    return _PPermute.apply(x, mesh, axis, [tuple(p) for p in perm])


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)`` (backward: the reverse swap)."""
    if mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)

