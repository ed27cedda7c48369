"""Carry parameters from the JAX package into the port.

The port keeps the JAX package's parameter layout (nested dicts, lists
for MLP layers), so a trained tree maps over leaf by leaf:

  * ``from_numpy_tree`` turns a nested dict/list of numpy arrays - e.g.
    ``jax.tree_util.tree_map(np.asarray, params)`` - into tensors on a
    device; with ``like`` (a port parameter tree, e.g. from ``init``)
    it checks that every key and shape matches the port's model;
  * ``load_checkpoint`` reads the framework-neutral checkpoint that
    ``repro/training/checkpoint.py`` writes (``arrays.npz`` +
    ``manifest.json``, leaves keyed by their "/"-joined tree path) back
    into such a nested tree.

bfloat16 leaves (the DLRM and xDeepFM tables) cross bit for bit.  JAX
hands them over as ``ml_dtypes.bfloat16`` arrays, which numpy sees as
2-byte voids and ``torch.from_numpy`` refuses; they are recognised by
their dtype's name (the port does not import ``ml_dtypes``) and
reinterpreted through ``uint16``.  ``np.savez`` stores them as plain
2-byte voids, so ``load_checkpoint`` takes their type from the
manifest.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_bf16(arr) -> bool:
    return arr.dtype.name == "bfloat16"


def _bf16_tensor(arr) -> torch.Tensor:
    """A 2-byte bfloat16 (or void) array -> a torch.bfloat16 tensor with
    the same bits."""
    bits = np.ascontiguousarray(arr).view(np.uint16)
    if not bits.flags.writeable:  # e.g. np.asarray of a JAX array
        bits = bits.copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _leaf(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if _is_bf16(arr):
        return _bf16_tensor(arr).to(device)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _torch_dtype(x) -> torch.dtype:
    """The dtype ``_leaf`` gives ``x``."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    arr = np.asarray(x)
    if _is_bf16(arr):
        return torch.bfloat16
    if arr.dtype.kind == "f":
        return torch.float32
    return torch.from_numpy(np.zeros(0, arr.dtype)).dtype


def _check(tree, like, path: str) -> None:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or '<root>'}: keys {got} do not match "
                             f"the port's {sorted(like)}")
        for k in like:
            _check(tree[k], like[k], f"{path}/{k}")
    elif isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{path}: expected a list of {len(like)}")
        for i, (a, b) in enumerate(zip(tree, like)):
            _check(a, b, f"{path}/{i}")
    elif tuple(np.shape(tree)) != tuple(like.shape):
        raise ValueError(f"{path}: shape {tuple(np.shape(tree))} != the "
                         f"port's {tuple(like.shape)}")
    else:
        dtype = getattr(like, "dtype", None)
        if isinstance(dtype, torch.dtype) and _torch_dtype(tree) != dtype:
            raise ValueError(f"{path}: dtype {_torch_dtype(tree)} != the "
                             f"port's {dtype}")


def from_numpy_tree(tree, *, like=None, device=None):
    """Nested dict/list of arrays -> the same structure of tensors on
    ``device`` (bfloat16 leaves as bfloat16, bit for bit; other float
    leaves as float32).  ``like`` checks structure, shapes and dtypes
    against a port parameter tree first; a trained reward
    model's top-level ``label_norm`` (which an untrained ``init`` tree
    lacks) is carried over unchecked."""
    device = resolve_device(device)
    if like is not None:
        core = tree
        if isinstance(tree, dict) and "label_norm" not in like:
            core = {k: v for k, v in tree.items() if k != "label_norm"}
        _check(core, like, "")

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _leaf(t, device)

    return conv(tree)


def _unflatten(flat: dict):
    """{"a/b/0/w": arr} -> nested dicts, lists where keys are indices."""
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def checkpoint_steps(ckpt_dir: str) -> list:
    """The steps of the committed checkpoints under ``ckpt_dir`` (a save
    in flight is a ``.step_*.tmp.*`` directory and does not count)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and ".tmp" not in d)


def read_checkpoint(ckpt_dir: str, *, step: int | None = None):
    """Read a checkpoint directory -> ({"/"-joined path: leaf}, manifest).
    Leaves are numpy arrays, except those the manifest names
    ``bfloat16``: numpy has no such type, so they come back as CPU
    ``torch.bfloat16`` tensors with the saved bits.  ``step`` defaults to
    the latest one."""
    if step is None:
        steps = checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for e in manifest["leaves"]:
            arr = np.asarray(data[e["name"]])
            if e["dtype"] == "bfloat16" and arr.dtype.kind == "V" \
                    and arr.dtype.itemsize == 2:
                arr = _bf16_tensor(arr)
            flat[e["key"]] = arr
    return flat, manifest


def load_checkpoint(ckpt_dir: str, *, step: int | None = None):
    """Read a ``training/checkpoint.save`` directory (of either package)
    -> (nested tree, manifest); leaves as ``read_checkpoint`` gives
    them."""
    flat, manifest = read_checkpoint(ckpt_dir, step=step)
    return _unflatten(flat), manifest
