"""Checkpoint: directory snapshot persisted to storage_path.

Port of ``ray_tpu/train/checkpoint.py``. A checkpoint IS a directory;
helpers move trees of tensors (or numpy arrays) in and out of it, in the
reference's layout: per state name a ``<name>.npz`` of the leaves under
the names ``"0"``, ``"1"``, ... in JAX's leaf order and a
``<name>.treedef.pkl``, or a ``<name>.pkl`` for anything else, and
``checkpoint_meta.json`` written last.

The treedef pickle is the port's own (``pytree.TreeDef`` and each leaf's
kind), since the reference's is a jax ``PyTreeDef``. A tensor leaf is
moved to the host before it is written (a CUDA tensor too), and a bf16
leaf, which numpy cannot hold, is written as its ``uint16`` bits with its
dtype recorded. A restored leaf comes back on the host, as a tensor of
its dtype (or the numpy array it was); the caller moves it, as the
reference's caller does with ``device_put``. A tree that is not all
arrays (``torch.optim.Optimizer.state_dict()``: its ``param_groups``
hold floats and bools) is pickled, as the reference pickles it, with its
tensors moved to the host first.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import pytree


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self):
        yield self.path

    # -- tree helpers (params are trees of tensors or numpy arrays) -----
    @classmethod
    def from_state(cls, state: Dict[str, Any], path: str) -> "Checkpoint":
        """Persist a {name: tree-or-json-able} dict as a checkpoint dir.

        ATOMIC: everything lands in a sibling temp dir first and
        ``os.replace``s into place, with ``checkpoint_meta.json``
        written last as the commit marker — a crash mid-write leaves
        either the old complete checkpoint or a ``.tmp-*`` orphan,
        never a half-written directory a restore could pick up."""
        path = os.path.abspath(path)
        parent = os.path.dirname(path) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(
            prefix=os.path.basename(path) + ".tmp-", dir=parent
        )
        try:
            meta: Dict[str, str] = {}
            for name, value in state.items():
                if _is_pytree_of_arrays(value):
                    leaves, treedef = pytree.flatten(value)
                    host = [_to_savable(x) for x in leaves]
                    np.savez(
                        os.path.join(tmp, f"{name}.npz"),
                        **{str(i): a for i, (a, _) in enumerate(host)},
                    )
                    with open(
                        os.path.join(tmp, f"{name}.treedef.pkl"), "wb"
                    ) as f:
                        pickle.dump(
                            {"treedef": treedef, "kinds": [k for _, k in host]}, f
                        )
                    meta[name] = "pytree"
                else:
                    if any(isinstance(x, torch.Tensor) for x in pytree.leaves(value)):
                        value = pytree.tree_map(_host_tensor, value)
                    with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
                        pickle.dump(value, f)
                    meta[name] = "pickle"
            with open(os.path.join(tmp, "checkpoint_meta.json"), "w") as f:
                json.dump(meta, f)
            try:
                os.replace(tmp, path)
            except OSError:
                # target exists non-empty (caller overwrites a previous
                # checkpoint at the same path): drop it, then swap
                shutil.rmtree(path, ignore_errors=True)
                os.replace(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return cls(path)

    def load_state(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "checkpoint_meta.json")) as f:
            meta = json.load(f)
        out: Dict[str, Any] = {}
        for name, kind in meta.items():
            if kind == "pytree":
                data = np.load(os.path.join(self.path, f"{name}.npz"))
                arrays = [data[str(i)] for i in range(len(data.files))]
                with open(
                    os.path.join(self.path, f"{name}.treedef.pkl"), "rb"
                ) as f:
                    desc = pickle.load(f)
                leaves = [
                    _from_saved(a, k) for a, k in zip(arrays, desc["kinds"])
                ]
                out[name] = pytree.unflatten(desc["treedef"], leaves)
            else:
                with open(os.path.join(self.path, f"{name}.pkl"), "rb") as f:
                    out[name] = pickle.load(f)
        return out


def _host_tensor(x: Any) -> Any:
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _to_savable(x: Any):
    """(numpy array as written, leaf kind): a tensor's kind is its dtype's
    name; a bf16 tensor is written as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        kind = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), kind
        return t.numpy(), kind
    return np.asarray(x), None


def _from_saved(a: np.ndarray, kind: Optional[str]) -> Any:
    if kind is None:
        return a
    if kind == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _is_pytree_of_arrays(value: Any) -> bool:
    leaves: List[Any] = pytree.leaves(value)
    return bool(leaves) and all(
        isinstance(x, (np.ndarray, np.generic, torch.Tensor))
        or hasattr(x, "__array__")
        for x in leaves
    )
