"""Counted FLOPs and peak live bytes of one step, run on meta tensors (the
port's counterpart of the JAX package's `launch/hlo_analysis.py`).

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

`collective_stats` keeps the JAX result's keys; on one card each is 0.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["COLLECTIVES", "collective_stats", "LiveBytes", "analyze_step", "depth_scaled",
           "loops_over_tokens", "tree_nbytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_stats(*_args, **_kw) -> dict:
    """The JAX package's `collective_stats` keys for a one-card step: no
    collective runs, so every byte count and the count are 0."""
    out = {k: 0 for k in COLLECTIVES}
    out.update(total=0, raw_total=0, count=0)
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
    FlopCounterMode and `LiveBytes`: {"flops": counted FLOPs,
    "flops_by_op": {op: FLOPs}, "temp_size_in_bytes": peak bytes of the
    storages the step allocated (outputs included), "output_size_in_bytes":
    the outputs' bytes outside the arguments}."""
    counter = FlopCounterMode(display=False)
    live = LiveBytes(known=args)
    with counter, live:
        out = fn(*args)
    arg_keys = live.known
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in _tensors(out)}
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()),
            "flops_by_op": by_op,
            "temp_size_in_bytes": int(live.peak),
            "output_size_in_bytes": int(sum(n for k, n in outs.items() if k not in arg_keys))}


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
    return {"flops": scale(r1["flops"], r2["flops"]),
            "flops_by_op": {op: scale(r1["flops_by_op"].get(op, 0), r2["flops_by_op"].get(op, 0))
                            for op in ops},
            "temp_size_in_bytes": scale(r1["temp_size_in_bytes"], r2["temp_size_in_bytes"]),
            "output_size_in_bytes": scale(r1["output_size_in_bytes"],
                                          r2["output_size_in_bytes"]),
            "depth_scaled": reps}
