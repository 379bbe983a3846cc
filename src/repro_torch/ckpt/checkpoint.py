"""Checkpointing: numpy payloads + JSON manifest, atomic and async save.

The port of the reference's ``repro/ckpt/checkpoint.py``, in the same
on-disk format, so a checkpoint of a plain dict tree written by either
package restores in the other bit for bit::

    <dir>/step_<N>/          N as %08d
      manifest.json          {"step", "extra", "leaves": {path: {"file",
                              "shape", "dtype", "crc32"}}}
      <leaf-id>.npy          one file per leaf (path with "/" -> "__")

* Leaves are addressed by stable path strings, not flatten order. A tree
  is nested dicts, lists, tuples and NamedTuples (the optimizer's
  ``AdamWState`` and ``QuantState``: their field names are path parts) of
  tensors or numpy arrays; an ``nn.Module`` stands for its parameters,
  each dotted name split into path parts (``layers.3.attn.wq`` is
  ``layers/3/attn/wq``).
* numpy has no bfloat16: a bf16 leaf is stored as its ``uint16`` bit
  pattern with the dtype name ``"bfloat16"`` in the manifest, as the
  reference stores it.
* A save is atomic (written to ``step_<N>.tmp``, then renamed) and every
  leaf carries a crc32 of its stored bytes, checked on restore, so a
  failure mid-save never corrupts the latest checkpoint.
* :class:`AsyncCheckpointer` snapshots to host memory synchronously and
  serializes on a background thread.

:func:`restore` returns new tensors on a ``device``; :func:`restore_into`
copies a checkpoint into live tensors in place (the training runner's
restart).

Distribution: a DTensor leaf is saved as its global array (every rank
takes part in the gather; rank 0 writes), in the same format.
``restore(..., mesh=, specs=)`` places each leaf that has a spec as a
DTensor laid out by the sanitized spec on any mesh — the elastic re-mesh:
each rank reads the array, slices its own shard on the host and moves
only that to the device; nothing is sent.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_into",
           "save"]

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """(path parts, leaf) for every leaf of ``tree``; None is no leaf."""
    if tree is None:
        return
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + tuple(name.split(".")), p
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten(x, prefix + (str(i),))
    else:
        yield prefix, tree


def _rebuild(tree, fn, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; a module
    becomes nested dicts of its parameters by name."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        out: dict = {}
        for parts, p in _flatten(tree):
            node = out
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = fn(prefix + parts, p)
        return out
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, fn, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def _path_str(parts) -> str:
    return _SEP.join(parts)


def _leaf_id(path: str) -> str:
    return path.replace(_SEP, "__")


def _to_savable(leaf) -> tuple[np.ndarray, str]:
    """The leaf as a numpy array numpy can store, and its dtype name (a
    DTensor as its global array)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":            # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.name != name:
        raise ValueError(f"stored dtype {arr.dtype.name} for a {name} leaf")
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic checkpoint save; returns the step's directory.
    Under a process group every rank calls it (a DTensor leaf is gathered)
    and rank 0 writes; the others wait for it."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if any(hasattr(leaf, "full_tensor") for _, leaf in _flatten(tree)) \
            and dist.is_initialized():
        arrays = [(parts, _to_savable(leaf)) for parts, leaf in
                  _flatten(tree)]
        if dist.get_rank() == 0:
            _write(final, step, arrays, extra)
        dist.barrier()
        return final
    return _write(final, step, ((parts, _to_savable(leaf))
                                for parts, leaf in _flatten(tree)), extra)


def _write(final: str, step: int, arrays, extra) -> str:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for parts, (arr, dtype_name) in arrays:
        path = _path_str(parts)
        fname = _leaf_id(path) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _open(ckpt_dir: str, step: Optional[int]):
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return d, json.load(f)


def _load(d: str, manifest: dict, path: str, verify: bool) -> torch.Tensor:
    meta = manifest["leaves"].get(path)
    if meta is None:
        raise KeyError(f"checkpoint missing leaf {path!r}")
    arr = np.load(os.path.join(d, meta["file"]))
    if verify and zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
            != meta["crc32"]:
        raise IOError(f"checksum mismatch for {path!r}")
    return _from_savable(arr, meta["dtype"])


def _spec_key(path: str) -> str:
    """A path with dotted parameter names split as a module's are, so a
    spec keyed by ``layers.3.attn.wq`` finds a module's leaf."""
    return path.replace(".", _SEP)


def _spec_paths(specs, prefix=()) -> dict:
    """{spec key: spec} of a spec tree (dicts, NamedTuples; the specs are
    tuples themselves)."""
    from ..models.common import is_spec
    if is_spec(specs):
        return {_spec_key(_path_str(prefix)): specs}
    out = {}
    if isinstance(specs, dict):
        for k, v in specs.items():
            out.update(_spec_paths(v, prefix + (str(k),)))
    elif _is_namedtuple(specs):
        for f in specs._fields:
            out.update(_spec_paths(getattr(specs, f), prefix + (f,)))
    return out


def _shard_of(t: torch.Tensor, spec, mesh, device):
    """The DTensor laid out as ``spec`` (sanitized) on ``mesh`` whose
    shard on this rank is sliced from the host array ``t``: only the
    shard is moved to ``device``."""
    from ..models.common import (placements, sanitize_spec, shard_bounds,
                                 sharded)
    spec = sanitize_spec(spec, tuple(t.shape), mesh)
    if mesh.get_coordinate() is None:        # a rank outside the mesh
        local = t.new_empty((0,))
    else:
        n, lo = shard_bounds(t.shape, mesh, placements(mesh, spec))
        local = t[tuple(slice(a, a + k) for a, k in zip(lo, n))]
    return sharded(local.contiguous().to(device), t.shape, mesh, spec)


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            device=None, verify: bool = True, mesh=None, specs: Any = None):
    """Read the checkpoint at ``step`` (default: the latest) in the
    structure of ``target``. Returns (tree, manifest): the tree's leaves
    are new tensors on ``device`` (default: each target tensor's device,
    the CPU for other leaves); a module in ``target`` comes back as nested
    dicts of its parameters. With ``mesh`` and ``specs`` (a tree of specs
    by the target's paths: dicts, NamedTuples, or parameter names) each
    leaf with a spec is a DTensor on ``mesh`` laid out by its sanitized
    spec, its shard on ``device`` (default: the mesh's device type) —
    onto ANY mesh (elastic restore). Raises ``IOError`` on a checksum
    mismatch."""
    d, manifest = _open(ckpt_dir, step)
    by_path = _spec_paths(specs) if mesh is not None and specs is not None \
        else {}

    def one(parts, leaf):
        path = _path_str(parts)
        t = _load(d, manifest, path, verify)
        spec = by_path.get(_spec_key(path))
        if spec is not None:
            dev = device if device is not None else mesh.device_type
            return _shard_of(t, spec, mesh, dev)
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        return t.to(dev)
    return _rebuild(target, one), manifest


@torch.no_grad()
def restore_into(ckpt_dir: str, target: Any, step: Optional[int] = None,
                 verify: bool = True) -> dict:
    """Copy the checkpoint at ``step`` (default: the latest) into the
    tensors of ``target`` in place, each leaf's shape checked. Returns the
    manifest."""
    d, manifest = _open(ckpt_dir, step)
    for parts, leaf in _flatten(target):
        path = _path_str(parts)
        t = _load(d, manifest, path, verify)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(t.shape)} "
                             f"!= live shape {tuple(leaf.shape)}")
        leaf.copy_(t)
    return manifest


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, serialize on a background
    thread; keep the ``keep`` latest steps. A failed save raises on the
    next :meth:`save` or :meth:`wait`."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _rebuild(tree, lambda _, x: (
            x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else np.array(x)))

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def _gc(self):
        for s in _steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
