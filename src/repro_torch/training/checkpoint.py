"""Atomic, self-describing checkpoints in the JAX package's format.

A checkpoint is ``step_XXXXXXXXXX/`` holding ``arrays.npz`` (leaves
``leaf_00000``, ``leaf_00001``, ... in JAX's leaf order) and
``manifest.json`` (each leaf's path key, name, shape and dtype).  Path
keys are JAX's (``repro_torch.tree``): for a ``TrainState``, ``0`` for
the step, ``1/<params path>``, and ``2/.step``, ``2/.mu/...``,
``2/.nu/...`` for AdamW's state.  So a checkpoint written by either
package restores in the other, bit for bit.

* atomic: written to ``.step_XXXXXXXXXX.tmp.*/`` then renamed;
* ``keep``: the most recent ``keep`` checkpoints are kept;
* ``restore`` reads through ``bridge.read_checkpoint`` (which also reads
  bfloat16 leaves) into the structure, dtypes and devices of a target
  tree.  Restoring onto a mesh waits for the model-parallel training port
  (ROADMAP queue A item 26).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.bridge import checkpoint_steps, read_checkpoint
from repro_torch.tree import leaves_with_paths, unflatten


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as saved, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # np.savez keeps them as 2-byte voids
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, state, *, keep: int = 3,
         extra_meta: dict | None = None) -> str:
    """Atomically write ``state`` (any tree) as checkpoint ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=f".step_{step:010d}.tmp.", dir=ckpt_dir)
    try:
        manifest = {"step": step, "leaves": [], "extra": extra_meta or {}}
        arrays = {}
        for i, (key, leaf) in enumerate(leaves_with_paths(state)):
            arr, dtype = _to_numpy(leaf)
            name = f"leaf_{i:05d}"
            arrays[name] = arr
            manifest["leaves"].append({"key": key, "name": name,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(arr, leaf):
    """A saved leaf in ``leaf``'s type: a tensor of its dtype on its
    device, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype, copy=False)


def restore(ckpt_dir: str, target, *, step: int | None = None, mesh=None):
    """(``target``'s structure filled from checkpoint ``step``, default the
    latest; manifest).  Each leaf takes its target leaf's dtype and
    device."""
    if mesh is not None:
        raise NotImplementedError("restoring onto a mesh waits for the "
                                  "model-parallel training port (ROADMAP "
                                  "queue A item 26)")
    flat, manifest = read_checkpoint(ckpt_dir, step=step)
    out = []
    for key, leaf in leaves_with_paths(target):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        out.append(_like(flat[key], leaf))
    return unflatten(target, out), manifest


def _gc(ckpt_dir: str, keep: int):
    for s in checkpoint_steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
