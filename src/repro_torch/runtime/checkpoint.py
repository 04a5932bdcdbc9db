"""Checkpointing: atomic, asynchronous, retention-managed, in the JAX
package's file format (``runtime/checkpoint.py``), so a checkpoint written by
either package restores in the other.

Format: one ``.npz`` per checkpoint holding the flattened tree (keys are
``/``-joined paths; a bf16 leaf is stored as its uint16 bits under a
``bf16::`` prefix) and a JSON meta sidecar. Writes go to a temporary file
that is ``os.replace``d into place, so a crash mid-write never corrupts the
latest checkpoint. ``save_async`` copies the tree to the host, then writes it
on a worker thread while training goes on. ``restore`` returns tensors on the
CPU; the caller moves them where they belong.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.utils import flatten_dict, tree_map, unflatten_dict

# tap names contain dots ("layers.attn.q"): the separator must not
_SEP = "/"
_BF16 = "bf16::"


def _host(leaf) -> Any:
    """A leaf as the host holds it: a CPU tensor (a copy, detached) or a
    Python / numpy scalar as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _to_numpy_tree(tree) -> dict[str, np.ndarray]:
    flat = (flatten_dict(tree, sep=_SEP) if isinstance(tree, dict)
            else {"__root__": tree})
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[_BF16 + k] = v.view(torch.int16).numpy().view(np.uint16)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


def _from_numpy_tree(d: dict[str, np.ndarray]):
    out = {}
    for k, v in d.items():
        if k.startswith(_BF16):
            out[k[len(_BF16):]] = torch.from_numpy(
                np.ascontiguousarray(v).view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    if set(out) == {"__root__"}:
        return out["__root__"]
    return unflatten_dict(out, sep=_SEP)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- paths ---------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                try:
                    out.append(int(f[5:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------
    def save(self, step: int, tree, meta: dict | None = None) -> str:
        path = self._path(step)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:      # file handle: savez must not append .npz
            np.savez(f, **_to_numpy_tree(tree))
        os.replace(tmp, path)
        with open(path + ".meta.json.tmp", "w") as f:
            json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
        os.replace(path + ".meta.json.tmp", path + ".meta.json")
        self._gc()
        return path

    def save_async(self, step: int, tree, meta: dict | None = None) -> None:
        """Copy to the host (the only part that blocks), then write on a
        worker thread."""
        self.wait()
        host_tree = tree_map(_host, tree)
        self._thread = threading.Thread(
            target=self._save_guarded, args=(step, host_tree, meta), daemon=True)
        self._thread.start()

    def _save_guarded(self, step, tree, meta):
        try:
            self.save(step, tree, meta)
        except Exception as e:  # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            for suffix in (".npz", ".npz.meta.json"):
                try:
                    os.remove(os.path.join(self.dir, f"ckpt_{s:010d}" + suffix))
                except OSError:
                    pass

    # -- restore ---------------------------------------------------------
    def restore(self, step: int | None = None):
        """(step, tree of CPU tensors) of checkpoint ``step`` (default the
        latest), or None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with np.load(self._path(step), allow_pickle=False) as z:
            tree = _from_numpy_tree({k: z[k] for k in z.files})
        return step, tree
