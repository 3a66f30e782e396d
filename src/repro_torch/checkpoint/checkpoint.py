"""Checkpoint/restart for fault-tolerant training. Port of
``repro.checkpoint.checkpoint``, in the same on-disk format, so a
checkpoint written by one package restores in the other.

Format: one directory per step containing
  * ``manifest.json``  — step, the index of leaves (path, shard, shape,
    dtype) and user extras
  * ``shard_<i>.npz``  — leaf arrays, chunked so no single file exceeds
    ``max_shard_bytes``; a leaf's key is its tree path joined by ``/``
    and stored with ``\\x1f`` in place of each ``/``

Leaves are named by their paths in JAX's leaf order (dict keys sorted;
:func:`repro_torch.utils.tree_leaves_with_path`). Writes are atomic (tmp
dir + rename) and optionally asynchronous (the manager copies tensors to
host numpy first, so the training loop never blocks on disk). Restore
rebuilds a template's tree, as tensors on each template leaf's device.

On a mesh every rank calls ``CheckpointManager.save`` with its blocks and
their ``shardings`` (:class:`repro_torch.launch.sharding.NamedSharding`
trees): the leaves are gathered whole and rank 0 writes them, as the JAX
package's ``np.asarray`` of a global array does. ``shardings=`` on
restore gives each rank its block of every leaf, on the mesh that saved
or on any other.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils import tree_leaves_with_path, tree_map, tree_unflatten


def _key_str(path) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is copied off its device)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: cast the leaf first")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and "tmp" not in d)


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extras: dict | None = None,
                    max_shard_bytes: int = 1 << 30) -> str:
    """Synchronous atomic save; returns the checkpoint path."""
    pairs = tree_leaves_with_path(tree)
    names = [_key_str(p) for p, _ in pairs]
    arrays = [_host(v) for _, v in pairs]

    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + f".tmp.{os.getpid()}.{time.time_ns() // 1000}"
    os.makedirs(tmp, exist_ok=True)

    shards: list[dict[str, np.ndarray]] = [{}]
    sizes = [0]
    index = {}
    for name, arr in zip(names, arrays):
        if sizes[-1] + arr.nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shard_id = len(shards) - 1
        shards[shard_id][name] = arr
        sizes[-1] += arr.nbytes
        index[name] = {"shard": shard_id, "shape": list(arr.shape),
                       "dtype": str(arr.dtype)}

    for i, shard in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i}.npz"),
                 **{k.replace("/", "\x1f"): v for k, v in shard.items()})
    manifest = {"step": step, "index": index, "n_shards": len(shards),
                "extras": extras or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(directory: str, *, step: int | None = None,
                    template: Any | None = None, shardings: Any | None = None):
    """Load the latest (or given) step. Returns (step, tree, extras).

    ``template``: a tree whose structure the restored leaves are put into,
    each as a tensor on its template leaf's device (names alone do not
    determine structure). Without one the tree is a dict of path -> numpy
    array. ``shardings``: a matching tree of ``NamedSharding``; each leaf
    is then this rank's block under it (elastic restore onto a new mesh).
    """
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    data = {}
    for i in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{i}.npz")) as z:
            for k in z.files:
                data[k.replace("\x1f", "/")] = z[k]

    if template is None:
        return step, data, manifest["extras"]

    leaves = []
    for p, like in tree_leaves_with_path(template):
        arr = torch.from_numpy(data[_key_str(p)])
        leaves.append(arr.to(like.device) if isinstance(like, torch.Tensor)
                      else arr)
    tree = tree_unflatten(template, leaves)
    if shardings is not None:
        tree = tree_map(lambda x, sh: sh.local(x), tree, shardings)
    return step, tree, manifest["extras"]


def _lead() -> bool:
    """Whether this process writes (rank 0, or no process group)."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class CheckpointManager:
    """Keep-last-k async checkpointer."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, *, extras: dict | None = None,
             shardings: Any | None = None):
        """Write ``tree`` as step ``step``. ``shardings``: ``tree`` holds
        this rank's blocks under them; every rank calls this, the leaves
        are gathered whole, and rank 0 writes."""
        if shardings is not None:
            from repro_torch.launch.sharding import gather_tree
            tree = gather_tree(tree, shardings)
            if not _lead():
                return
        # snapshot to host first so training can proceed
        host_tree = tree_map(_host, tree)
        self.wait()

        def work():
            save_checkpoint(self.directory, step, host_tree, extras=extras)
            self._gc()

        if self.async_save:
            def guarded():
                try:
                    work()
                except BaseException as exc:  # re-raised by wait()
                    self._error = exc

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        """Block until the pending save is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template=None, *, step=None, shardings=None):
        """``load_checkpoint`` of this directory. ``shardings``: every rank
        calls this and gets its blocks, once rank 0's pending save is on
        disk."""
        self.wait()
        if shardings is not None and dist.is_available() \
                and dist.is_initialized():
            dist.barrier()
        return load_checkpoint(self.directory, step=step, template=template,
                               shardings=shardings)

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
