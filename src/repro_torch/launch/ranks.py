"""Ranks of a mesh for the launchers' ``--devices``.

``--devices 2x2`` is a (data=2, model=2) mesh, ``2x2x1`` a (pod=2,
data=2, model=1) one, as the JAX launchers read it. :func:`launch` runs a
function on every rank of such a mesh: under ``torchrun`` (``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR`` in the environment) the process group
comes from the environment; otherwise it spawns the ranks itself, joined
through a file store in a temporary directory. The backend is gloo on the
CPU, and on cards too when the ranks outnumber them (NCCL refuses two
ranks on one card); NCCL when each rank has a card of its own.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist


def parse_devices(text: str) -> tuple[tuple, tuple]:
    """``"DxM"`` -> ((D, M), ("data", "model")); ``"PxDxM"`` -> ((P, D,
    M), ("pod", "data", "model"))."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if len(shape) == 2:
        return shape, ("data", "model")
    if len(shape) == 3:
        return shape, ("pod", "data", "model")
    raise ValueError(f"--devices takes DxM or PxDxM, got {text!r}")


def backend_for(device_type: str, world: int) -> str:
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank(rank: int, world: int, init: str, shape, axes, device_type,
          fn, args) -> None:
    from repro_torch.launch.mesh import make_test_mesh
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend_for(device_type, world),
                            init_method=init, rank=rank, world_size=world)
    try:
        fn(make_test_mesh(shape, axes, device_type=device_type), *args)
    finally:
        dist.destroy_process_group()


def launch(fn, devices: str, device, *args) -> None:
    """``fn(mesh, *args)`` on every rank of the ``devices`` mesh (each rank
    a process), on ``device``'s type (None: the card)."""
    shape, axes = parse_devices(devices)
    world = math.prod(shape)
    device_type = torch.device("cuda" if device is None else device).type
    if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--devices {devices} needs {world} ranks, the "
                             f"launcher started {os.environ['WORLD_SIZE']}")
        _rank(int(os.environ["RANK"]), world, "env://", shape, axes,
              device_type, fn, args)
        return
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank, args=(world, f"file://{tmp}/store", shape, axes,
                         device_type, fn, args),
            nprocs=world, join=True, start_method="spawn")
