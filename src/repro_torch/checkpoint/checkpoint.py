"""Checkpointing: atomic, async, and the reference's file format.

The port of the reference's ``repro.checkpoint``, with its layout:
  <dir>/step_00000123.npz.tmp -> fsync -> rename to step_00000123.npz
  <dir>/MANIFEST.json          latest committed step, published by rename

The npz keys are the reference's: each leaf's "/"-joined dict path
("params/layers/attn/wq", "opt/m/...", "opt/step"). bf16 leaves are
widened to f32 on save (npz has no bf16) and narrowed to the template's
dtype on restore, so a checkpoint either package writes restores in the
other.

  * atomicity: a preempted save never corrupts the latest checkpoint
    (write to a temporary, fsync, rename; the manifest follows the
    commit).
  * async: `AsyncCheckpointer` copies the tree to host memory on the
    caller's thread, then writes it on a background thread, so the train
    loop does not wait for the disk.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array for the npz; bf16 (numpy has none) widened
    to f32."""
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _unflatten_into(template: Dict, flat: Dict[str, np.ndarray],
                    device=None) -> Dict:
    """``template``'s tree with each leaf read from ``flat`` by its path,
    in the template leaf's dtype, on ``device`` (default: the template
    leaf's; a template on the meta device needs one)."""
    def load(path, leaf):
        t = torch.as_tensor(flat[path])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint {path}: shape {tuple(t.shape)}, "
                             f"expected {tuple(leaf.shape)}")
        return t.to(device=device or leaf.device, dtype=leaf.dtype)
    paths = dict(tree_lib.items(template))
    return tree_lib.unflatten(template, [load(p, leaf)
                                         for p, leaf in paths.items()])


def save(ckpt_dir: str, step: int, tree: Dict) -> str:
    """Atomic synchronous save. Returns the committed path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {path: _host(leaf) for path, leaf in tree_lib.items(tree)}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    manifest = {"latest_step": step, "time": time.time(),
                "n_arrays": len(flat)}
    mtmp = os.path.join(ckpt_dir, "MANIFEST.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.rename(mtmp, os.path.join(ckpt_dir, "MANIFEST.json"))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    mpath = os.path.join(ckpt_dir, "MANIFEST.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return int(json.load(f)["latest_step"])


def restore(ckpt_dir: str, step: int, template: Dict, device=None) -> Dict:
    """Load ``step`` into ``template``'s structure and dtypes, on
    ``device`` (default: each template leaf's device)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat, device)


class AsyncCheckpointer:
    """Snapshot to host memory on call, write on a daemon thread."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Dict) -> None:
        self.wait()  # at most one in-flight save
        # a synchronous copy: the caller may update the tensors in place
        # as soon as this returns
        host_tree = tree_lib.map_(
            lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
