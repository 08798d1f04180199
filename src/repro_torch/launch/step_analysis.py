"""Counted FLOPs, peak live bytes and collective bytes of one step, run on
meta tensors (the port's counterpart of the JAX package's
`launch/hlo_analysis.py`).

The JAX package parses compiled HLO for two reasons: XLA's static cost
analysis counts a scanned layer's body once, not once per layer, and it
reports no collective bytes.  The port runs its layers as a Python loop,
so it needs no parser: `analyze_step` runs the step itself on meta tensors
(no storage, no arithmetic) under `torch.utils.flop_counter.FlopCounterMode`,
which counts every matmul, einsum and convolution of every layer, forward
and backward, as it is dispatched.  Elementwise work (norms, softmax, the
recurrent states' updates) is not counted, as XLA's dot-only count would
not either.  Beside the FLOPs it takes the step's peak bytes of live
intermediates, the counterpart of `memory_analysis().temp_size_in_bytes`:
a dispatch mode adds every new storage an op returns to a running total
and takes it off when the storage is freed.  Unlike XLA's number it
includes the step's outputs where a step does not donate its arguments: a
functional train step's new parameters and optimizer state are allocated
while the old ones are still alive, as on the card.  A donated train step
(`make_train_step(donate=True)`) writes them into the arguments' storage,
which the count leaves out, as XLA leaves out donated buffers.

Where a mixer loops over tokens in Python (`models/ssm.py`'s Mamba scan,
the "ref" WKV loop of `kernels/rwkv6_wkv/ref.py`), a step dispatches a few
ops per token per layer, and a meta op costs ~0.2 ms of Python: rwkv6-7b's
32 layers at 32 768 tokens would take hours.  `depth_scaled` counts such a
step as `hlo_analysis` counts a while body, by its trip count: it runs the
step with the config's one stage cut to 1 repeat and to 2, and takes each
number as X1 + (R - 1) (X2 - X1).  The FLOPs are exact, since the repeats
run the same layers in sequence.  The temp bytes are exact where each
further repeat adds the same live bytes at the peak (a train step's saved
activations, gradients and new parameters; a prefill's per-layer cache and
its stacked copy), as at the smoke sizes the tests run it at.  `dryrun.py`
uses it for the train and prefill steps of configs whose layers loop over
tokens (`loops_over_tokens`).

The collectives of a meshed step are counted as they are dispatched
(`CollectiveBytes`, the counterpart of `hlo_analysis.collective_stats`'
reading of the post-SPMD HLO): every `c10d` collective (all-reduce,
all-gather, reduce-scatter, all-to-all, broadcast) and every
`_c10d_functional` one that reaches the dispatcher, on meta tensors under
torch's fake process group (the dry run on the production mesh) as on a
real one.  Each is priced as the JAX result prices it: the bytes of the
op's result on one device (the gathered tensor of an all-gather, the
tensor of an all-reduce, the scattered block of a reduce-scatter, the
output of an all-to-all; a broadcast, which the JAX result has no key
for, counts under "collective-permute").  `depth_scaled` scales them by
the stage's repeats as `hlo_analysis` scales a while body by its trip
count.  `collective_stats(counted)` returns the JAX result's keys; with
no run every one is 0, as on one card.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["COLLECTIVES", "collective_stats", "CollectiveBytes", "LiveBytes", "analyze_step",
           "depth_scaled", "loops_over_tokens", "tree_nbytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# Dispatcher op name -> (JAX result key, where the op's result is: "args0"
# the first argument (the c10d ops write into it), "out" the return value).
_OPS = {
    "c10d::allreduce_": ("all-reduce", "args0"),
    "c10d::allreduce_coalesced_": ("all-reduce", "args0"),
    "c10d::allgather_": ("all-gather", "args0"),
    "c10d::_allgather_base_": ("all-gather", "args0"),
    "c10d::allgather_coalesced_": ("all-gather", "args0"),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "args0"),
    "c10d::reduce_scatter_": ("reduce-scatter", "args0"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "args0"),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", "args0"),
    "c10d::alltoall_": ("all-to-all", "args0"),
    "c10d::alltoall_base_": ("all-to-all", "args0"),
    "c10d::broadcast_": ("collective-permute", "args0"),
    "_c10d_functional::all_reduce": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional::broadcast": ("collective-permute", "out"),
}
_PACKAGE = __name__.rsplit(".", 2)[0]          # "repro_torch"
_COMM = f"{_PACKAGE}.sharding.comm"


_PLUMBING = (f"{_PACKAGE}.sharding.", f"{_PACKAGE}.models.tensor_parallel.")


def _call_site() -> str:
    """The port's code that called the collective: the innermost frame of
    the package outside `sharding.comm` ("models.moe._ep_moe"); behind a
    helper of `sharding` or `models.tensor_parallel`, the helper and the
    code it serves ("models.tensor_parallel.row <
    models.attention.gqa_forward"); in a backward pass the `sharding.comm`
    operator whose backward called it ("sharding.comm._ColParallel.backward");
    marked "[remat]" where a remat boundary's recompute ran it."""
    frame, site, remat = sys._getframe(2), None, False
    while frame is not None:
        mod, code = frame.f_globals.get("__name__", ""), frame.f_code
        name = f"{mod[len(_PACKAGE) + 1:]}.{code.co_qualname.split('.<locals>')[0]}"
        if mod == "torch.utils.checkpoint":
            remat |= code.co_name == "recompute_fn"
        elif mod == _COMM:
            if code.co_name == "backward" and site is None:
                site = name
                break
        elif mod.startswith(_PACKAGE + ".") and mod != __name__:
            plumbing = f"{mod}.{code.co_qualname}".startswith(_PLUMBING)
            if site is None:
                site = name if plumbing else None
                if not plumbing:
                    site = name
                    break
            elif not plumbing:
                site = f"{site} < {name}"
                break
        frame = frame.f_back
    while frame is not None and not remat:
        remat = (frame.f_globals.get("__name__") == "torch.utils.checkpoint"
                 and frame.f_code.co_name == "recompute_fn")
        frame = frame.f_back
    return (site or "?") + (" [remat]" if remat else "")


class CollectiveBytes(TorchDispatchMode):
    """Counts the collectives dispatched while the mode is on: `calls`
    {(JAX op key, call site, bytes of the result on this device): number
    of calls} (`_OPS`, `_call_site`)."""

    def __init__(self):
        super().__init__()
        self.calls: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = _OPS.get(func._schema.name)
        if op is not None:
            key, where = op
            nbytes = sum(t.nbytes for t in _tensors(args[0] if where == "args0" else out))
            self.calls[(key, _call_site(), int(nbytes))] += 1
        return out


def collective_stats(calls: dict | None = None, *, detail: bool = False,
                     raw: dict | None = None) -> dict:
    """The JAX package's `collective_stats` keys from counted collectives
    ({(op, site, bytes): calls}, `CollectiveBytes.calls`, depth-scaled
    where the step was): each op's bytes per device, "total", "raw_total"
    (the bytes of `raw`, the calls as they ran, default `calls`) and
    "count" (the number of calls in `raw`); with `detail` "top", the 15
    largest as (op, bytes, repeats, site), repeats the calls of that op,
    site and size.  With no calls (one card) every number is 0."""
    calls, raw = dict(calls or {}), dict(raw if raw is not None else calls or {})
    out = {k: 0 for k in COLLECTIVES}
    for (op, _, nbytes), n in calls.items():
        out[op] += nbytes * n
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["raw_total"] = sum(nbytes * n for (_, _, nbytes), n in raw.items())
    out["count"] = sum(raw.values())
    if detail:
        items = [(op, nbytes * n, n, site) for (op, site, nbytes), n in calls.items()]
        out["top"] = sorted(items, key=lambda t: (-t[1], t[0], t[3]))[:15]
    return out


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tree_nbytes(tree) -> int:
    """Summed nbytes of every tensor in a tree (dicts, lists, tuples,
    NamedTuples), each storage counted once."""
    seen: dict[int, int] = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """Peak bytes of the storages that ops allocate while the mode is on.

    Storages of `known` tensors (the step's arguments) are never counted;
    a view or an in-place op returns a storage already seen, so only new
    allocations add.  A storage leaves the total when it is freed
    (`weakref.finalize` on the storage)."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {t.untyped_storage()._cdata for t in _tensors(known)}
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.known:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.current += n
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, key)
        return out


def analyze_step(fn, *args) -> dict:
    """Run fn(*args) once, every tensor on the meta device, under
    FlopCounterMode, `LiveBytes` and `CollectiveBytes`: {"flops": counted
    FLOPs, "flops_by_op": {op: FLOPs}, "temp_size_in_bytes": peak bytes of
    the storages the step allocated (outputs included),
    "output_size_in_bytes": the outputs' bytes outside the arguments,
    "collective_calls": `CollectiveBytes.calls` (empty off a mesh) and
    "raw_collective_calls", the calls as they ran (the same here;
    `depth_scaled` scales the first and keeps its one-repeat run's as the
    second, as an HLO module holds a while body once)}."""
    counter = FlopCounterMode(display=False)
    live = LiveBytes(known=args)
    coll = CollectiveBytes()
    with counter, live, coll:
        out = fn(*args)
    arg_keys = live.known
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in _tensors(out)}
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()),
            "flops_by_op": by_op,
            "temp_size_in_bytes": int(live.peak),
            "output_size_in_bytes": int(sum(n for k, n in outs.items() if k not in arg_keys)),
            "collective_calls": dict(coll.calls),
            "raw_collective_calls": dict(coll.calls)}


def loops_over_tokens(cfg, kind: str) -> bool:
    """Whether a `kind` ("train" | "prefill" | "decode") step of `cfg` runs
    a Python loop over its tokens: a Mamba layer, or an RWKV layer on the
    "ref" WKV path.  A decode step has one token."""
    from ..models.transformer import stage_plan

    mixers = {k.mixer for st in stage_plan(cfg) for k in st.pattern}
    return kind != "decode" and ("mamba" in mixers
                                 or ("rwkv" in mixers and cfg.rwkv_wkv_impl == "ref"))


def depth_scaled(cfg, run) -> dict:
    """`analyze_step`'s result for `cfg`, from run(cfg') -> analyze_step
    result on the config cut to 1 and to 2 repeats of its one stage,
    scaled to its R repeats (module docstring); adds "depth_scaled": R, or
    0 where R <= 2 and the config ran as it is."""
    from ..models.transformer import stage_plan

    stages = stage_plan(cfg)
    if len(stages) != 1:
        raise NotImplementedError(f"depth_scaled: {cfg.name} has {len(stages)} stages; "
                                  "it scales a config of one stage")
    st = stages[0]
    reps = st.repeats
    if reps <= 2:
        return {**run(cfg), "depth_scaled": 0}
    cut = [dataclasses.replace(cfg, n_layers=len(st.pattern) * r) for r in (1, 2)]
    for r, c in zip((1, 2), cut):
        if stage_plan(c) != [dataclasses.replace(st, repeats=r)]:
            raise AssertionError(f"depth_scaled: {cfg.name} cut to {r} periods plans "
                                 f"{stage_plan(c)}, not {r} repeats of {st.pattern}")
    r1, r2 = run(cut[0]), run(cut[1])

    def scale(x1, x2):
        return x1 + (reps - 1) * (x2 - x1)

    ops = set(r1["flops_by_op"]) | set(r2["flops_by_op"])
    c1, c2 = r1["collective_calls"], r2["collective_calls"]
    calls = {key: scale(c1.get(key, 0), c2.get(key, 0)) for key in set(c1) | set(c2)}
    return {"flops": scale(r1["flops"], r2["flops"]),
            "flops_by_op": {op: scale(r1["flops_by_op"].get(op, 0), r2["flops_by_op"].get(op, 0))
                            for op in ops},
            "temp_size_in_bytes": scale(r1["temp_size_in_bytes"], r2["temp_size_in_bytes"]),
            "output_size_in_bytes": scale(r1["output_size_in_bytes"],
                                          r2["output_size_in_bytes"]),
            "collective_calls": {key: n for key, n in calls.items() if n},
            "raw_collective_calls": c1,
            "depth_scaled": reps}
