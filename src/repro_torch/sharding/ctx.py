"""The sharding context the model's per-rank code is threaded with (the
JAX package's `ShardCtx`): the mesh, its data-parallel and expert-parallel
axes, and how attention is sharded."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["ShardCtx", "meshed"]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The sharding context threaded through the model (the JAX package's
    `ShardCtx`), for per-rank code on a `torch.distributed` DeviceMesh.

    mesh=None: single-device math, today's code bit for bit.  With a mesh,
    the residual stream is this rank's data shard of the batch (or, with
    batch_sharded=False, the whole batch on every rank: a batch the data
    axes do not divide), replicated over `model`, and the layers are
    partitioned over `model` as the rules lay their weights out
    (`models.tensor_parallel`: column- and row-parallel dense layers,
    head-parallel attention and RWKV, channel-parallel Mamba); the MoE is
    expert-parallel over `ep_axis`.  attn_shard, where the kv heads do not
    divide `model` (the projections then gathered whole): "auto" runs the
    plain attention on every model rank (the JAX package leaves it to
    GSPMD); "explicit" routes full-sequence causal attention through
    `models.attention.sharded_causal_attention` (sequence-parallel when the
    sequence divides `model`).  Head-parallel attention is the same under
    both."""

    mesh: Any = None
    dp_axes: tuple = ("data",)       # activation batch axes
    ep_axis: str = "model"           # expert-parallel axis
    attn_shard: str = "auto"         # "auto" | "explicit"
    batch_sharded: bool = True

    def size(self, axis: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def ep_size(self) -> int:
        return 1 if self.mesh is None else self.size(self.ep_axis)

    @property
    def dp_size(self) -> int:
        return math.prod(self.size(a) for a in self.dp_axes)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def dp_rank(self) -> int:
        """This rank's index among the data shards (pod-major across pods)."""
        r = 0
        for a in self.dp_axes:
            r = r * self.size(a) + self.rank(a)
        return r

    def dp_group(self):
        """The process group over the data axes (flattened across pods)."""
        if len(self.dp_axes) == 1:
            return self.mesh.get_group(self.dp_axes[0])
        return self.mesh[tuple(self.dp_axes)]._flatten().get_group()

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)


def meshed(ctx: ShardCtx | None) -> bool:
    """Whether `ctx` puts the model on a mesh (None and mesh=None do not)."""
    return ctx is not None and ctx.mesh is not None
