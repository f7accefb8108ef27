"""Fault-tolerant checkpointing: atomic writes, manifest, auto-resume.

Counterpart of ``repro.train.checkpoint``, with the same on-disk layout, so
that a checkpoint written by either package loads in the other:

  <dir>/step_000123/
      arrays.npz          (flattened leaves, ``leaf_0`` .. ``leaf_{n-1}``)
      treedef.json        (``{"names": [...]}``: each leaf's path)
      aux.json            (optional caller-owned JSON payload, see ``aux=``)
      MANIFEST.json       (step, written_at, n_leaves, checksums, complete)
  <dir>/latest            (text file with the last COMPLETE step)

Guarantees:
* torn writes never count: MANIFEST is written *after* the arrays, and
  ``latest`` is updated with ``os.replace`` (atomic on POSIX) only after it.
* restore validates the manifest's checksums before loading.
* leaves round-trip **bitwise**: tensors go in as numpy arrays (moved to the
  host, dtype kept: int32 stays int32) and a structure-free restore
  (``tree_like=None``) hands them back uncast.

Trees are flattened as the reference's pytrees flatten: ``None`` holds no
leaf; a dict's entries go in key order (``['key']``); a tuple's or list's in
position (``[i]``); a dataclass's or named tuple's fields in declaration
order (``.field``), a dataclass listing only the fields named by its
``tree_fields`` attribute when it has one; anything else is a leaf.
A caller that cannot know its structure before restore (``serve.SvdService``)
saves a JSON ``aux`` spec beside the arrays and rebuilds the structure from
it (``load_aux`` + ``restore(dir, None)`` + ``tree_unflatten``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["available_steps", "latest_step", "load_aux", "restore", "save",
           "tree_flatten_with_names", "tree_leaves", "tree_unflatten"]


def _children(node):
    """``[(path suffix, child), ...]`` of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = getattr(node, "tree_fields", None)
        if names is None:
            names = [f.name for f in dataclasses.fields(node)]
        return [(f".{f}", getattr(node, f)) for f in names]
    return None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; cast the state before saving")
        return leaf.numpy()
    return np.asarray(leaf)


def tree_flatten_with_names(tree) -> tuple[list[str], list]:
    """``(names, leaves)`` of ``tree`` in flattening order (leaves as given)."""
    names, leaves = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            names.append(path)
            leaves.append(node)
            return
        for suffix, child in kids:
            walk(child, path + suffix)

    walk(tree, "")
    return names, leaves


def tree_leaves(tree) -> list:
    return tree_flatten_with_names(tree)[1]


def tree_unflatten(skeleton, leaves):
    """``skeleton``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return node._replace(**{f: build(getattr(node, f)) for f in node._fields})
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return dataclasses.replace(node, **{s[1:]: build(c) for s, c in kids})

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def save(ckpt_dir: str | Path, step: int, tree, *, keep: int = 3, aux=None) -> Path:
    """Atomically write ``tree`` as checkpoint ``step``.

    ``aux``: optional JSON-serialisable payload written to ``aux.json`` and
    covered by the manifest's checksums (read it back with ``load_aux``).
    """
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:09d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:09d}"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)

    names, leaves = tree_flatten_with_names(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(tmp_dir / "arrays.npz", **arrays)

    checksums = {}
    with open(tmp_dir / "arrays.npz", "rb") as f:
        checksums["arrays.npz"] = hashlib.sha256(f.read()).hexdigest()
    if aux is not None:
        aux_bytes = json.dumps(aux).encode()
        (tmp_dir / "aux.json").write_bytes(aux_bytes)
        checksums["aux.json"] = hashlib.sha256(aux_bytes).hexdigest()

    (tmp_dir / "treedef.json").write_text(json.dumps({"names": names}))
    manifest = {
        "step": step,
        "written_at": time.time(),
        "n_leaves": len(leaves),
        "checksums": checksums,
        "complete": True,
    }
    (tmp_dir / "MANIFEST.json").write_text(json.dumps(manifest))

    if step_dir.exists():
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)

    latest_tmp = ckpt_dir / ".latest_tmp"
    latest_tmp.write_text(str(step))
    os.replace(latest_tmp, ckpt_dir / "latest")

    _gc(ckpt_dir, keep)
    return step_dir


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(available_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)


def available_steps(ckpt_dir: str | Path):
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for d in ckpt_dir.iterdir():
        if d.is_dir() and d.name.startswith("step_") and (d / "MANIFEST.json").exists():
            try:
                m = json.loads((d / "MANIFEST.json").read_text())
                if m.get("complete"):
                    out.append(int(m["step"]))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue
    return out


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    marker = ckpt_dir / "latest"
    if marker.exists():
        try:
            s = int(marker.read_text().strip())
            if (ckpt_dir / f"step_{s:09d}" / "MANIFEST.json").exists():
                return s
        except ValueError:
            pass
    steps = available_steps(ckpt_dir)
    return max(steps) if steps else None


def _resolve_step(ckpt_dir: Path, step: int | None) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    return step


def load_aux(ckpt_dir: str | Path, step: int | None = None):
    """The checksum-validated ``aux`` payload of a checkpoint: ``(step, aux)``,
    ``aux`` None when the checkpoint was written without one."""
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    step_dir = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    expected = manifest["checksums"].get("aux.json")
    if expected is None:
        return step, None
    aux_bytes = (step_dir / "aux.json").read_bytes()
    if hashlib.sha256(aux_bytes).hexdigest() != expected:
        raise IOError(f"checkpoint {step_dir} failed aux.json checksum validation")
    return step, json.loads(aux_bytes)


def restore(ckpt_dir: str | Path, tree_like=None, step: int | None = None):
    """Load a checkpoint; returns ``(step, tree)``.

    With ``tree_like`` the leaves are unflattened into its structure (each
    cast to its target leaf's dtype when that leaf has one).  With
    ``tree_like=None`` the raw numpy leaves come back as a flat list in saved
    order, **uncast and bitwise-exact**.
    """
    ckpt_dir = Path(ckpt_dir)
    step = _resolve_step(ckpt_dir, step)
    step_dir = ckpt_dir / f"step_{step:09d}"

    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    with open(step_dir / "arrays.npz", "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != manifest["checksums"]["arrays.npz"]:
        raise IOError(f"checkpoint {step_dir} failed checksum validation")

    with np.load(step_dir / "arrays.npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    if tree_like is None:
        return step, leaves
    flat_like = tree_leaves(tree_like)
    if len(flat_like) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves; target structure has "
                         f"{len(flat_like)}")
    restored = []
    for leaf, like in zip(leaves, flat_like):
        if isinstance(like, torch.Tensor):
            restored.append(torch.as_tensor(leaf).to(like.dtype))
        elif hasattr(like, "dtype"):
            restored.append(np.asarray(leaf).astype(like.dtype))
        else:
            restored.append(leaf)
    return step, tree_unflatten(tree_like, restored)
