"""Meshes and local devices (PyTorch counterpart of the JAX package's
`launch/mesh.py`).

Two kinds of "across devices" live here:

  * the model's mesh: a `torch.distributed` `DeviceMesh` of dims ("data",
    "model") — ("pod", "data", "model") across pods — over the ranks of a
    process group, one rank per device (`make_production_mesh`,
    `smoke_mesh`, `dp_axes_of`, `mesh_shape`);
  * the simulation's shards: single-controller, like the JAX package's
    `shard_map` over `jax.local_devices()`.  One process drives every local
    device (`local_devices`); work that splits into independent rows or
    cells runs one shard per device, each shard on a thread of its own so
    that every device has work queued before any shard's host waits
    (`map_shards`).  No collective is involved.

`fake_mesh` is the dry run's mesh: torch's fake process group (rank 0
of a 256- or 512-rank world, or any shape asked for; every collective is
dispatched and returns at once) and a `DeviceMesh` of that shape on it,
for per-rank code on meta tensors: the counterpart of the JAX dry run's
512 forced host devices.  It is scoped: it refuses to start beside a
process group already made, and destroys its own on exit.

`emulate_devices(n)` is the counterpart of XLA's
`--xla_force_host_platform_device_count`: inside it, `local_devices`
returns n copies of the one device asked for, so the sharded paths run
(and are held bitwise to the unsharded ones) on a host with one CPU or one
card.  It is a scoped context manager, never an environment variable.

Importing this module touches no device and no process group: every mesh
is made inside a function.
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

from ..device import resolve_device

__all__ = ["make_production_mesh", "dp_axes_of", "smoke_mesh", "mesh_shape", "fake_mesh",
           "local_devices", "emulate_devices", "use_shards", "map_shards", "split_padded"]

PRODUCTION_SHAPE = {False: (16, 16), True: (2, 16, 16)}
PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(data=16, model=16) over 256 ranks, or (pod=2, data=16, model=16)
    over 512, on the process group already initialised (a real one, or
    torch's fake process group for a dry run)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), PRODUCTION_SHAPE[multi_pod],
                            mesh_dim_names=PRODUCTION_AXES[multi_pod])


@contextlib.contextmanager
def fake_mesh(*, multi_pod: bool = False, shape: dict | None = None):
    """Within this block, the default process group is torch's fake one,
    rank 0 of a world of the mesh's size, and the block gets its
    `DeviceMesh` on "cpu": the production mesh ((data=16, model=16), or
    with multi_pod (pod=2, data=16, model=16)), or `shape` ({axis: size})
    when given.  Refuses (RuntimeError) when a default process group
    already exists; destroys its own on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a default process group already exists; the dry run's "
                           "fake group runs only in a process of its own")
    if shape is None:
        shape = dict(zip(PRODUCTION_AXES[multi_pod], PRODUCTION_SHAPE[multi_pod]))
    world = 1
    for n in shape.values():
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield init_device_mesh("cpu", tuple(shape.values()), mesh_dim_names=tuple(shape))
    finally:
        dist.destroy_process_group()


def dp_axes_of(mesh) -> tuple:
    """The activation-batch (data-parallel) axes of a mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def smoke_mesh(data: int = 1, model: int = 1, device_type: str | None = None):
    """A (data, model) mesh over the initialised process group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{axis name: size}: all the sharding rules read of a mesh.  Takes a
    `DeviceMesh` or a mapping already in this form."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# ---------------------------------------------------------------------------
# the simulation's single-controller shards
# ---------------------------------------------------------------------------

_emulated = threading.local()


@contextlib.contextmanager
def emulate_devices(n: int):
    """Within this block (on this thread), `local_devices(device)` returns
    `n` copies of `device`: the sharded paths run with n shards on one
    device.  The counterpart of `--xla_force_host_platform_device_count`."""
    if n < 1:
        raise ValueError(f"emulate_devices: n={n} must be >= 1")
    prev = getattr(_emulated, "n", None)
    _emulated.n = n
    try:
        yield
    finally:
        _emulated.n = prev


def local_devices(device=None) -> list[torch.device]:
    """The devices this process shards over: every visible CUDA device when
    `device` resolves to CUDA, else the CPU; inside `emulate_devices(n)`,
    n copies of the resolved device."""
    device = resolve_device(device)
    n = getattr(_emulated, "n", None)
    if n is not None:
        return [device] * n
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def use_shards(shard: bool | None, devices: Sequence[torch.device]) -> bool:
    """The JAX package's rule: None shards when more than one device is
    visible; True on one device is the unsharded path; False never shards."""
    return len(devices) > 1 and (shard is None or bool(shard))


def split_padded(n: int, n_shards: int) -> list[list[int]]:
    """Indices 0..n-1 in n_shards contiguous blocks of equal size, the last
    padded by repeating index 0 (pad-and-drop: a caller drops what a pad
    index gives back)."""
    per = -(-n // n_shards)
    idx = list(range(n)) + [0] * (per * n_shards - n)
    return [idx[j * per:(j + 1) * per] for j in range(n_shards)]


def map_shards(fn: Callable, items: Sequence, devices: Sequence[torch.device]) -> list:
    """[fn(item, device) for each (item, device) pair], one thread per
    shard, so each device has its work queued while another shard's host
    waits on a read.  A CUDA shard's thread makes its device current; a
    CPU shard's thread uses the caller's intra-op thread count, so a shard
    runs the very kernels it would run alone.  The first failure is
    raised."""
    if len(items) != len(devices):
        raise ValueError(f"map_shards: {len(items)} items for {len(devices)} devices")
    if len(items) == 1:
        return [fn(items[0], devices[0])]
    n_threads = torch.get_num_threads()

    def one(item, device):
        torch.set_num_threads(n_threads)
        if device.type == "cuda":
            with torch.cuda.device(device):
                return fn(item, device)
        return fn(item, device)

    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        futures = [pool.submit(one, item, dev) for item, dev in zip(items, devices)]
        return [f.result() for f in futures]
