"""Round-body pieces shared by the scan and async engines.

The async engine's bit-exact sync-limit contract holds only while both
engines run the SAME float ops for the leader step, the client-training
draw discipline and the eval path — so those pieces live here once,
imported by `fl.sim._build_scan_runner` and `fl.async_loop` (and by the
hierarchy's two engines, `fl.hierarchical` and `fl.hier_async`).

Every piece works on a GROUP of B cells at once — the port of the JAX
package's `vmap` over a `run_many` group.  `group_data` stacks the cells'
`fl.sim._scan_inputs` dicts: the leader plane's operands gain a cell axis,
while the learning plane stays per cell (`data["cells"]`), since a batched
GEMM is not the bits of the cells' own GEMMs.  `sync_group_round` is the
group's whole sync round (the async event's counterpart is
`fl.async_loop.group_event`); `sync_cell_round` is its one-cell case.  A
cell's results are the bits it gets in a group of one: the leader masks
frozen cells, the per-cell reductions run along the last axis, and K3 takes
every cell in one launch with each cell's own operations
(`kernels.fedavg_agg.fedavg_aggregate_leaves_batched`).

A `run_hier_many` group of G hierarchy configs, each of C cells, is C such
groups that share the configs' global models: `group_data` stacks the
configs' `fl.hierarchical._hier_scan_inputs` dicts (a config axis first,
the cell axis second), and `group_cell_data` takes cell c of every config
as one flat group of G, which the hierarchy's engines run in cell order.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call, grad

from ..core.leader_torch import first_true, host_ints, leader_round_cells
from ..kernels.fedavg_agg import cell_buffers
from .server import aggregate

__all__ = ["group_data", "stack_cells", "make_group_leader", "make_leader_branches",
           "at_channel", "train_cells", "make_eval_fn", "eval_cells", "make_xs",
           "cell_data", "group_cell_data", "lift_x", "sync_group_round",
           "sync_cell_round"]

# The per-cell leader-plane operands of `fl.sim._scan_inputs` ((N,) / (S,)),
# and its per-round ones (a leading rounds axis).
_CELL_KEYS = ("beta", "clusters", "fixed_ids")
_ROUND_KEYS = ("gamma", "feas", "energy", "sel_perms", "assign_perms")
# One round's leader operands, as `make_xs` slices them.
_X_KEYS = ("gamma", "feas", "energy", "sel_perm", "assign_perm")


def _stack(vals: list, dim: int) -> torch.Tensor:
    """torch.stack, or a view for one tensor."""
    return vals[0].unsqueeze(dim) if len(vals) == 1 else torch.stack(vals, dim)


def group_data(cells: Sequence[dict], *, rounds: bool = True) -> dict:
    """One group's `data` dict from its cells' `fl.sim._scan_inputs` dicts
    (or its configs' `fl.hierarchical._hier_scan_inputs` dicts).

    The leader operands gain a cell axis: first on the per-cell ones (beta,
    clusters, fixed_ids: (B, N); a hierarchy's (G, C, N)), second on the
    per-round ones (gamma (R, B, K, N), a hierarchy's (R, G, C, K, N), ...;
    skipped with ``rounds=False``).  The commit operands follow, at the cell
    tier and at a hierarchy's global tier (`g_` names): `buffer` stays an int
    when every cell has the same, else a (B,) tensor; `stale_exp` and
    `server_lr` become (B,).  `cells` keeps the dicts themselves for the
    learning plane, and `spans` lists the runs of cells with one policy as
    (policy index, start, stop): the leader runs once per run, so cells
    sorted by `policy_idx` make one run per policy.  A group of one is lifted
    by views, without a copy."""
    out = {name: _stack([c[name] for c in cells], 0) for name in _CELL_KEYS}
    if rounds:
        out.update({name: _stack([c[name] for c in cells], 1) for name in _ROUND_KEYS})
    for tier in ("", "g_"):
        if tier + "buffer" not in cells[0]:
            continue
        buffers = [c[tier + "buffer"] for c in cells]
        out[tier + "buffer"] = (buffers[0] if len(set(buffers)) == 1 else
                                torch.tensor(buffers, device=out["beta"].device))
        for name in ("stale_exp", "server_lr"):
            out[tier + name] = _stack([c[tier + name] for c in cells], 0)
    if "t0" in cells[0]:
        out["t0"] = cells[0]["t0"]
    spans: list[tuple[int, int, int]] = []
    for i, c in enumerate(cells):
        p = c["policy_idx"]
        if spans and spans[-1][0] == p:
            spans[-1] = (p, spans[-1][1], i + 1)
        else:
            spans.append((p, i, i + 1))
    out.update(cells=list(cells), spans=spans)
    return out


def stack_cells(trees: Sequence[dict], lead: tuple[int, ...] | None = None) -> dict:
    """The cells' parameter dicts as one dict of (B, ...) leaves, laid out
    as K3's cell-axis outputs are (`cell_buffers`), so every cell's view of
    a leaf is aligned alike from the first round on.  `lead` splits the B
    trees' axis, row-major: (G, C) lays out a hierarchy group's cell
    models, config by config, every (config, cell) block aligned alike."""
    names = list(trees[0])
    first = trees[0][names[0]]
    bufs = cell_buffers([trees[0][k].shape for k in names], len(trees), first.device)
    for b, tree in enumerate(trees):
        for buf, k in zip(bufs, names):
            buf[b].copy_(tree[k])
    if lead is not None:
        bufs = [buf.unflatten(0, lead) for buf in bufs]
    return dict(zip(names, bufs))


def make_group_leader(policies: Sequence[tuple[str, str]], data, *, k: int, n: int,
                      n_clusters: int) -> Callable:
    """The group's leader step: fn(age, feasible, x) -> the lead dict of
    `core.leader_torch.leader_round_cells` over all B cells.

    Each run of cells with one policy (`data["spans"]`) goes through its
    (ds, sa) variant once, on a slice of every operand (no copy, no index
    tensor), and the runs are concatenated back in cell order: every cell
    runs only its own policy's arithmetic, where the JAX package's select
    runs every variant on every cell.  The feasibility mask is an explicit
    operand so the async engine can knock busy devices out of Prop-1 (the
    scan engine passes ``x["feas"]`` unchanged)."""
    def lead(age, feas, x) -> dict:
        outs = []
        for p, a, b in data["spans"]:
            ds, sa = policies[p]
            sl = slice(a, b)
            outs.append(leader_round_cells(
                age[sl], data["beta"][sl], x["gamma"][sl], feas[sl],
                x["sel_perm"][sl], x["assign_perm"][sl], x["t"],
                data["clusters"][sl], data["fixed_ids"][sl],
                ds=ds, sa=sa, k=k, n=n, n_clusters=n_clusters))
        if len(outs) == 1:
            return outs[0]
        return {name: (sum((o[name] for o in outs), []) if name == "iterations"
                       else torch.cat([o[name] for o in outs])) for name in outs[0]}

    return lead


def make_leader_branches(policies: Sequence[tuple[str, str]], data, *, k: int, n: int,
                         n_clusters: int) -> Callable:
    """One cell's leader step (`make_group_leader` of a group of one, the
    cell's policy `data["policy_idx"]`), for `sync_cell_round`."""
    return make_group_leader(policies, group_data([data], rounds=False),
                             k=k, n=n, n_clusters=n_clusters)


def train_cells(trainer, data, params: dict, draws: Sequence[Callable[[], torch.Tensor]],
                tx_ids: torch.Tensor, counts: Sequence[int]) -> dict | None:
    """The engines' shared training step and draw discipline, per cell:
    each cell with transmitters (`counts`, read on the host) trains its K
    slots from its own global model on its own data, drawing exactly one
    (K, local_steps, batch) uniforms block from its own stream — as the
    loop engine and the JAX package consume their streams; a cell without
    transmitters draws nothing.

    Returns the (B, K, ...) client parameters, the rows of a cell that did
    not train holding its global model (they carry weight 0), or None when
    no cell trained."""
    if not any(counts):
        return None
    outs = []
    for b, cnt in enumerate(counts):
        if cnt > 0:
            cell, ids = data["cells"][b], tx_ids[b]
            outs.append(trainer({name: v[b] for name, v in params.items()},
                                cell["x_all"][ids], cell["y_all"][ids],
                                cell["m_all"][ids], draws[b]()))
        else:
            outs.append(None)
    k = tx_ids.shape[-1]
    return {name: _stack([o[name] if o is not None else v[b].expand((k,) + v.shape[1:])
                          for b, o in enumerate(outs)], 0)
            for name, v in params.items()}


def make_eval_fn(model, data, track_gradnorm: bool):
    """The eval-round branch of one cell: (loss, accuracy,
    grad-norm^2-if-tracked) as float32 scalar tensors on the device (no
    host sync)."""
    x_full, y_full = data["x_full"], data["y_full"]

    def full_loss(p):
        logits = functional_call(model, p, (x_full,))
        return model.loss_per_example(logits, y_full).mean()

    def ev(p):
        with torch.no_grad():
            logits = functional_call(model, p, (x_full,))
            loss = model.loss_per_example(logits, y_full).mean()
            acc = model.correct(logits, y_full).mean()
        if track_gradnorm:
            gn = sum((g * g).sum() for g in grad(full_loss)(p).values())
        else:
            gn = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, acc, gn.to(torch.float32)

    return ev


def eval_cells(evs: Sequence[Callable], params: dict) -> tuple:
    """Every cell's eval on its own model and data: (B,) loss, accuracy and
    grad-norm^2."""
    outs = [ev({name: v[b] for name, v in params.items()}) for b, ev in enumerate(evs)]
    return tuple(_stack(list(col), 0) for col in zip(*outs))


def make_xs(data, rounds: int, eval_mask: np.ndarray) -> dict:
    """The per-round inputs both engines consume, each with a leading
    rounds axis: Γ slices, injected permutations, the eval mask (on the
    host, so the eval branch needs no sync) and the round index (Python
    ints)."""
    return dict(gamma=data["gamma"], feas=data["feas"],
                energy=data["energy"], sel_perm=data["sel_perms"],
                assign_perm=data["assign_perms"],
                eval_mask=np.asarray(eval_mask, bool),
                t=list(range(rounds)))


def cell_data(data: dict, c: int) -> dict:
    """Cell c's view of one hierarchy config's `data` dict: the flat
    engines' per-cell tensors (beta, clusters, fixed_ids, client data)."""
    return dict(data, **{name: data[name][c] for name in (
        "beta", "clusters", "fixed_ids", "x_all", "y_all", "m_all")})


def group_cell_data(data: dict, c: int) -> dict:
    """Cell c of every config of a hierarchy group (`group_data` of the
    configs' dicts) as one flat group's `data` dict: the leader operands
    (G, N) and the per-round traces (R, G, K, N), ..., each a contiguous
    copy; the cell tier's commit operands; `spans`; and, in `cells`, each
    config's own cell c (`cell_data`) for the learning plane."""
    out = {name: data[name][:, c].contiguous() for name in _CELL_KEYS}
    out.update({name: data[name][:, :, c].contiguous() for name in _ROUND_KEYS})
    out.update({name: data[name] for name in ("buffer", "stale_exp", "server_lr", "t0")
                if name in data})
    out.update(cells=[cell_data(d, c) for d in data["cells"]], spans=data["spans"])
    return out


def lift_x(x: dict) -> dict:
    """One cell's round inputs as a group of one's (views)."""
    return dict(x, **{name: x[name][None] for name in _X_KEYS})


def at_channel(mat: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """(B, K, N) per-(channel, device) values at each device's channel
    `ch` (B, N): mat[b, ch[b, i], i]."""
    return mat.gather(1, ch[:, None, :])[:, 0]


def sync_group_round(leader, trainer, data, x, params: dict, draws, age, *,
                     k: int, n: int) -> dict:
    """The group's synchronous round on the device: every cell's leader step,
    the eq.-9 barrier latency and energy of its transmitters, and the local
    training of the cells in which some device transmits — which the host
    reads once for the group, a (B,) vector — followed by one eq.-34 K3
    launch over every cell.

    `params` maps names to (B, ...) leaves, `draws` lists the cells'
    uniforms sources, `age` is (B, N).  Returns dict(lead, latency (B,),
    energy (B,), params, slot_w): `params` the aggregates, or the input
    models themselves when no cell transmits; `slot_w` the (B, K) slot
    weights (beta of each transmitter, 0 in empty slots)."""
    device = age.device
    kslot = torch.arange(k, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    lead = leader(age, x["feas"], x)
    tx = lead["transmitted"]
    ch_g = torch.where(tx, lead["channel_of"], 0)
    t_dev = at_channel(x["gamma"], ch_g)
    latency = torch.where(tx.any(-1), torch.where(tx, t_dev, -torch.inf).amax(-1), zero)
    energy = torch.where(tx, at_channel(x["energy"], ch_g), zero).sum(-1)
    tx_ids = first_true(tx, k)
    cnt = tx.sum(-1)
    slot_w = torch.where(kslot < cnt[:, None], data["beta"].gather(1, tx_ids), zero)
    cp = train_cells(trainer, data, params, draws, tx_ids, host_ints(cnt))
    if cp is not None:
        params = aggregate(params, cp, slot_w)
    return dict(lead=lead, latency=latency, energy=energy, params=params, slot_w=slot_w)


def sync_cell_round(leader, trainer, data, x, params, draws, age, *,
                    k: int, n: int) -> dict:
    """One cell's synchronous round: `sync_group_round` on a group of one
    (`leader` from `make_leader_branches`), the operands and results
    without the cell axis."""
    out = sync_group_round(leader, trainer, group_data([data], rounds=False), lift_x(x),
                           {name: v[None] for name, v in params.items()}, [draws],
                           age[None], k=k, n=n)
    return dict(lead={name: v[0] for name, v in out["lead"].items()},
                params={name: v[0] for name, v in out["params"].items()},
                **{name: out[name][0] for name in ("latency", "energy", "slot_w")})
