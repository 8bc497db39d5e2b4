"""Atomic checkpoints of a train state, in the names and on-disk layout of
the JAX package's ``checkpoint/ckpt.py``.

Layout: ``<dir>/step_<N>/`` holding ``manifest.json`` and one
``leaf_<i>.npy`` a leaf, the leaves in the sorted order of their paths.

* atomic: written to a temporary directory, then ``os.replace``d into
  place, so a crash mid-save never corrupts the previous checkpoint;
* restore: into the structure of a template (a fresh train state), each
  tensor written in place on its own device; a leaf of another shape
  raises;
* async: ``save_async`` snapshots to host memory and writes on a thread;
* retention: ``keep_last`` prunes old steps.

A tree is a nested mapping whose leaves are tensors, numpy arrays or
scalars; an ``nn.Module`` in it stands for its ``state_dict``.  A leaf's
path joins the keys with dots, so a train state's paths are its model's
``state_dict`` names under ``params.``, ``opt.m.*``, ``opt.v.*``,
``opt.step`` and ``grad_residual.*``.  bf16 tensors are stored as float32
(exact) and restored into the template's type.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

_MANIFEST = "manifest.json"


def _leaf_file(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def tree_paths(tree: Any, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        out = {}
        for k, sub in tree.items():
            out.update(tree_paths(sub, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, *,
         extra: Optional[dict] = None, keep_last: int = 3) -> str:
    """Blocking save.  Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    paths = tree_paths(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    try:
        meta = {"step": step, "extra": extra or {}, "leaves": []}
        for i, k in enumerate(sorted(paths)):
            arr = _host(paths[k])
            np.save(os.path.join(tmp, _leaf_file(i)), arr)
            meta["leaves"].append(
                {"path": k, "file": _leaf_file(i),
                 "shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(meta, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep_last)
    return final


def save_async(ckpt_dir: str, step: int, tree: Any,
               **kw) -> threading.Thread:
    """Snapshot to host memory now, write on a background thread (join it
    before relying on the checkpoint)."""
    host = {k: _host(v) for k, v in tree_paths(tree).items()}
    t = threading.Thread(target=save, args=(ckpt_dir, step, host),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, *,
            step: Optional[int] = None) -> tuple[Any, dict]:
    """Restore into the structure of ``template``: its tensors (and its
    modules' parameters and buffers) are overwritten in place; other leaves
    come back as numpy arrays in a new tree.  Returns ``(tree, manifest)``;
    ``tree`` holds ``template``'s tensors and modules."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        meta = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in meta["leaves"]}
    loaded = {}
    for k, tv in tree_paths(template).items():
        leaf = by_path.get(k)
        if leaf is None:
            raise KeyError(f"checkpoint missing leaf {k}")
        arr = np.load(os.path.join(d, leaf["file"]))
        want = tuple(getattr(tv, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"shape mismatch for {k}: ckpt {arr.shape} vs {want}")
        loaded[k] = arr
    return _fill(template, loaded, ""), meta


@torch.no_grad()
def _fill(tree, loaded: dict, prefix: str):
    if isinstance(tree, nn.Module):
        for k, t in tree.state_dict().items():
            t.copy_(torch.from_numpy(loaded[prefix + k]))
        return tree
    if isinstance(tree, Mapping):
        return {k: _fill(sub, loaded, f"{prefix}{k}.")
                for k, sub in tree.items()}
    arr = loaded[prefix[:-1]]
    if isinstance(tree, torch.Tensor):
        return tree.copy_(torch.from_numpy(arr))
    return arr


def _prune(ckpt_dir: str, keep_last: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
