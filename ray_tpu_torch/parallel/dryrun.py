"""Multi-rank dry run: training steps of the flagship model over a mesh.

Port of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``:
the same configurations, batches, sequences and optimizer. With 8 ranks,

- A: ``MeshConfig(dp=2, pp=2, tp=2)``, dense, 4 layers, B=8, T=32, four
  microbatches (2·pp);
- B: ``MeshConfig(dp=2, tp=2, sp=2)``, MoE with 4 experts over ``tp`` and
  ring attention over ``sp``, 2 layers, B=4, T=32;

with fewer, ``MeshConfig.auto(n)`` on A's model. ``optax.adamw(1e-3)`` is
``torch.optim.AdamW`` as ``make_train_step``'s docstring maps it. JAX runs
it on virtual CPU devices, since one chip cannot hold an 8-device mesh;
the port runs one process per rank (``parallel/launch.py``): gloo ranks on
the CPU, or NCCL ranks, one per card.

``train_rank`` is the rank program. Its parameters and tokens come from
seeds (``inputs``) or from the caller (the JAX package's, in the parity
tests), and it can return the first step's gradients in the full layout.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..models import transformer as tfm
from ..ops import flash_attention as fa
from .launch import launch
from .mesh import MeshConfig, build_mesh, local_shard

BASE = tfm.ModelConfig(vocab_size=512, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
                       d_ff=128, max_seq_len=64, dtype=torch.float32)
MOE = dataclasses.replace(BASE, n_layers=2, n_experts=4)

OPTIMIZERS = {
    # optax.adamw(1e-3) (torch's default weight decay is 1e-2, optax's 1e-4)
    "adamw": lambda ps, lr: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                              weight_decay=1e-4),
    "adam": lambda ps, lr: torch.optim.Adam(ps, lr=lr),
    "sgd": lambda ps, lr: torch.optim.SGD(ps, lr=lr),
}


@dataclass(frozen=True)
class Run:
    """One configuration: the mesh, the model, the global batch, the
    sequence length (the tokens are [batch, seq + 1]) and the pipeline's
    microbatches (0: the default, 2·pp)."""
    mesh: MeshConfig
    model: tfm.ModelConfig
    batch: int
    seq: int
    microbatches: int = 0

    @property
    def num_microbatches(self) -> int:
        if self.mesh.pp == 1:
            return 0
        return self.microbatches or 2 * self.mesh.pp


def runs(n: int) -> List[Run]:
    """The reference's configurations for ``n`` devices."""
    if n >= 8:
        return [Run(MeshConfig(dp=2, pp=2, tp=2), BASE, 8, 32),
                Run(MeshConfig(dp=2, tp=2, sp=2), MOE, 4, 32)]
    return [Run(MeshConfig.auto(n), BASE, 8, 32)]


def inputs(run: Run, device: DeviceLike = "cpu", seed: int = 0
           ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """The full parameters (from ``seed``) and tokens (from ``seed + 1``),
    drawn on ``device``."""
    device = resolve_device(device)
    params = tfm.init_params(run.model, torch.Generator(device=device).manual_seed(seed), device)
    tokens = torch.randint(0, run.model.vocab_size, (run.batch, run.seq + 1), device=device,
                           generator=torch.Generator(device=device).manual_seed(seed + 1))
    return params, tokens


def _grads(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _grads(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


def _numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_rank(runs: Sequence[Run], device: DeviceLike = None, optimizer: str = "adamw",
               lr: float = 1e-3, steps: int = 1, params: Optional[Sequence[Any]] = None,
               tokens: Optional[Sequence[np.ndarray]] = None, grads: bool = False
               ) -> List[Dict[str, Any]]:
    """Rank program: for each run, build its mesh, shard the parameters
    (``params[i]``, a numpy tree, or ``inputs``), and take ``steps`` steps of
    ``make_train_step`` on this rank's rows of the tokens. Returns per run
    the global losses, the first step's time, the mean time of the later
    steps, the flash kernels' launches in those steps, and with ``grads``
    the first step's reduced gradients gathered to the full layout (numpy,
    on rank 0)."""
    out = []
    for i, run in enumerate(runs):
        mesh = build_mesh(run.mesh, device)
        if params is None:
            full, tok = inputs(run, mesh.device)
        else:
            full = tfm.params_from_jax(params[i], "cpu")
            tok = torch.from_numpy(tokens[i])
        p = tfm.shard_params(full, run.model, mesh)
        del full
        leaves = [x.requires_grad_() for x in tfm.param_leaves(p)]
        opt = OPTIMIZERS[optimizer](leaves, lr)
        got: Dict[str, Any] = {}
        if grads:
            def capture(*_):  # the first step's gradients, after reduce_grads
                full_grads = tfm.gather_params(_grads(p), run.model, mesh)
                got["grads"] = _numpy(full_grads) if mesh.rank == 0 else None
                hook.remove()
            hook = opt.register_step_pre_hook(capture)
        step = tfm.make_train_step(run.model, opt, mesh, num_microbatches=run.num_microbatches)
        tok = local_shard(mesh, tok, "dp", None).to(mesh.device)
        _sync(mesh.device)
        t0 = time.perf_counter()
        losses = [step(p, tok)]
        _sync(mesh.device)
        first_s = time.perf_counter() - t0
        fa.flash_attention_forward.launches = 0
        fa.flash_attention_bwd_dq.launches = fa.flash_attention_bwd_dkv.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            losses.append(step(p, tok))
        _sync(mesh.device)
        rest_s = time.perf_counter() - t0
        out.append(dict(
            losses=[x.item() for x in losses], first_ms=first_s * 1e3,
            step_ms=rest_s / (steps - 1) * 1e3 if steps > 1 else None,
            launches=dict(fwd=fa.flash_attention_forward.launches,
                          dq=fa.flash_attention_bwd_dq.launches,
                          dkv=fa.flash_attention_bwd_dkv.launches),
            grads=got.get("grads")))
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> List[Dict[str, Any]]:
    """One ``adamw(1e-3)`` training step of each of ``runs(n_devices)`` over
    its mesh, on ``mesh.size`` ranks (NCCL on the cards, or gloo on
    ``device="cpu"``); prints and returns rank 0's results. Raises on a
    non-finite loss."""
    todo = runs(n_devices)
    results = launch(train_rank, todo[0].mesh.size, (todo, device), device=device)[0]
    for run, res in zip(todo, results):
        loss = res["losses"][0]
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} on mesh {run.mesh}")
        print(f"dryrun mesh {run.mesh}: loss={loss:.4f}")
    return results
