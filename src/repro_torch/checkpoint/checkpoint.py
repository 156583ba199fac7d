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
  * elastic: with ``shardings`` (a tree of `runtime.param_sharding.Shard`
    or None, `train.steps.state_blocks`), the split leaves (ZeRO-1
    blocks of the moments over "data", FSDP blocks of the parameters
    and their moments over "data", pieces of the parameters and moments
    over "model") are gathered first, every rank taking part, and rank 0
    alone writes the whole state in the same layout; `restore` with
    ``shardings`` splits a whole state again, for any mesh, with FSDP on
    or off.
  * host memory: a save holds the whole state on the writer's host in
    its own dtypes, and one leaf at a time as the f32 array written; a
    restore holds one whole leaf at a time.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.runtime import collectives


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array for the npz; bf16 (numpy has none) widened
    to f32."""
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _whole(leaf: torch.Tensor, shard) -> torch.Tensor:
    """The whole leaf of which ``leaf`` is this rank's `Shard` ``shard``
    (every rank calls this together): its block (ZeRO-1 or FSDP)
    gathered over "data", then its piece over "model"."""
    if shard is None:
        return leaf
    if shard.block is not None:
        full = leaf.new_empty(shard.block.full_shape(leaf.shape))
        collectives.gather_block(full, leaf, shard.block)
        leaf = full
    if shard.piece is not None:
        leaf = collectives.gather_piece(leaf, shard.piece)
    return leaf


def _writes(shardings) -> bool:
    """Whether this process writes: without ``shardings``, always; with
    them, rank 0 of the process group only."""
    if shardings is None:
        return True
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def host_tree(tree: Dict, shardings=None, copy=None) -> Optional[Dict]:
    """{path: the whole leaf on the host} (None on a process that does
    not write: module doc); ``copy`` (default: a CPU copy) moves a leaf
    there. Split leaves are gathered one at a time, on every rank."""
    copy = copy or (lambda t: t.detach().to("cpu", copy=True))
    blocks = (dict(tree_lib.items(shardings)) if shardings is not None
              else {})
    writes = _writes(shardings)
    out = {}
    for path, leaf in tree_lib.items(tree):
        whole = _whole(leaf, blocks.get(path))
        if writes:
            out[path] = copy(whole)
        del whole
    return out if writes else None


def save(ckpt_dir: str, step: int, tree: Dict, shardings=None
         ) -> Optional[str]:
    """Atomic synchronous save. Returns the committed path (None on a
    rank that does not write: module doc)."""
    flat = host_tree(tree, shardings)
    if flat is None:
        return None
    return _write(ckpt_dir, step, flat)


def _write(ckpt_dir: str, step: int, flat: Dict) -> str:
    """The npz of ``flat`` ({path: tensor}), as ``np.savez`` writes it,
    each leaf made a host array (`_host`) only as it is written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in flat.items():
                arr = _host(leaf)
                with zf.open(key + ".npy", "w", force_zip64=True) as out:
                    np.lib.format.write_array(out, np.asanyarray(arr),
                                              allow_pickle=False)
                del arr
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


def restore(ckpt_dir: str, step: int, template: Dict, device=None,
            shardings=None) -> Dict:
    """Load ``step`` into ``template``'s structure and dtypes (the whole
    state's shapes), on ``device`` (default: each template leaf's
    device; a template on the meta device needs one); where
    ``shardings`` gives a leaf a `Shard`, only this rank's part of it,
    whatever mesh wrote it (elastic). The arrays are read one
    at a time, each narrowed to its block and moved before the next, so
    the host holds one whole leaf at most."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    blocks = (dict(tree_lib.items(shardings)) if shardings is not None
              else {})
    leaves = []
    with np.load(path) as z:
        for key, leaf in tree_lib.items(template):
            t = torch.as_tensor(z[key])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {key}: shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(leaf.shape)}")
            shard = blocks.get(key)
            if shard is not None:
                t = shard.take(t).clone()
            leaves.append(t.to(device=device or leaf.device,
                               dtype=leaf.dtype))
            del t
    return tree_lib.unflatten(template, leaves)


class AsyncCheckpointer:
    """Snapshot to host memory on call, write on a daemon thread."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Dict, shardings=None) -> None:
        """``shardings``: as `save`'s; the gathers run here, on the
        caller's thread, on every rank."""
        self.wait()  # at most one in-flight save
        # a synchronous copy: the caller may update the tensors in place
        # as soon as this returns
        host_flat = host_tree(tree, shardings)
        if host_flat is None:
            return

        def work():
            try:
                _write(self.ckpt_dir, step, host_flat)
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
