"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the paper simulation
(`run_simulation`) and its multi-cell hierarchy (`run_hierarchical`,
`run_hier_many`) through K1-K3 on all three engines and checks their traces
against the same runs on the CPU, and again with the Γ solver's plain
projection backends (`ra_backend`), which route round K1 and K2, runs a `run_many` group of 16 cells and a
`run_hier_many` group of 8 hierarchy configs as one batch on each device
engine (every cell and config bitwise its solo run) and again sharded over
emulated devices, runs the sweep harness (`run_sweep`) and
the sustained service (`SustainedService`) on them, serves all ten models of the
model zoo (`serve_loop`) at full width through K4 and K5 (qwen2-7b, rwkv6-7b, the MoE
granite-moe-3b-a800m, stablelm-3b at head dim 80 and yi-6b at full depth,
qwen1.5-110b at 16 of its 80 layers, the MLA deepseek-v3-671b at 5 of 61,
the Mamba hybrid jamba-v0.1-52b at 8 of 32, and at full depth the audio
encoder-decoder whisper-base and the VLM qwen2-vl-2b), and trains qwen2-7b,
rwkv6-7b, deepseek-v3-671b, jamba-v0.1-52b, whisper-base and qwen2-vl-2b
(`train_loop`, the donated step) at full width with the depth cut, and
trains granite-moe-3b-a800m on a (1, 1) mesh through the sharded model
(expert-parallel MoE, sharded attention) as a world of one.
Phases, in order:

  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. kernel build (one nvcc per source, all four started together; plain C
     interfaces loaded with ctypes);
  3. K2, the polyblock projection, against its plain version, float64 and
     float32, at 2 x 131072 vertices and at the main path's shape; at both,
     the one-thread-per-vertex schedule and the cooperative one at 4, 8 and
     16 lanes per vertex timed side by side and held bitwise equal, with
     each one's critical path, and K2's bound priced from its SASS;
  4. K1, the whole Algorithm-1 solve, against its plain version, float64
     and float32, at 32768 devices x 4 sub-channels and at the main path's
     shape; at both, the one-thread-per-pair schedule and the cooperative
     one at 4, 8 and 16 lanes per child timed side by side and held
     bitwise equal, with each one's critical path (the longest pair's
     dependent evaluations of g at the measured latency per evaluation);
     then K2's lanes swept over 1 024 to ~2.3 x 10^5 of those pairs'
     first children (the sizes its lanes rule is set from);
  5. K3, the eq.-34 weighted mean, against its plain version (random,
     all-zero and single-slot weights, bitwise) at the main path's shapes
     (the six mnist-MLP leaves, K = 4, one grouped launch, timed on the card
     and as called beside the same leaves one launch each) and at K = 16,
     N = 2^25; its cell axis at 1, 16 and 32 cells of those leaves, one
     launch, each cell bitwise its plain version and its own one-cell
     launch, timed beside one one-cell launch per cell;
  6. K4, flash attention, against its plain version at qwen2-7b's prefill
     shape (B 4, S 512, Hq 28, Hkv 4, D 128, causal) and stablelm-3b's
     (Hq = Hkv = 32, D 80) in bf16 and f32, each also at a right-aligned,
     windowed shape (Sq < Sk), and D 80's time per FLOP beside D 128's; K5, the WKV6 recurrence, at
     rwkv6-7b's prefill shape (4 x 512 x 64 heads x 64) and its T = 1
     decode shape; each with its time on the card, as called, its bound,
     the plain version's time and the library call's (SDPA for K4); the
     bf16 K4 entry's tensor-core instructions (SASS), shared memory and
     registers, and K5's threads per block, shared memory and registers;
  7. the simulation's main paths, each driven with every launch counter
     set to 0 just before it and read just after:
     run_simulation(SimConfig(rounds=30)) — mnist MLP at full width, N=20,
     K=4, Table-I settings, Γ through K1, aggregation through K3 — on
     engine="loop", then ra_solver="step" for 10 rounds through K2, then
     engine="scan", then aggregation="async" and "async_full" on the async
     engine; traces equal to the device="cpu" run, losses within 1e-4 of
     it, async_full bitwise equal to the card's scan run, and K2 launched
     exactly 9 times on the step run; then one warm 10-round run of the
     loop, step and scan paths under torch.profiler (the card's busy time
     and idle share; K2's summed device time on the step run) and one
     10-round run of each engine under torch's sync debug mode (every host
     sync, by source line);
  8. the hierarchy's main paths, each driven with every launch counter set
     to 0 just before it and read just after: HierSimConfig(rounds=30) —
     mnist MLP at full width, 2 cells x 10 devices x 4 sub-channels, 400
     samples, Γ for all cells in one K1 launch, aggregation through K3 at
     both tiers — on engine="loop", "scan" and the two-tier async engine
     (aggregation="async" at both tiers), async_full at both tiers held
     bitwise equal to the card's scan run, 10 rounds with
     ra_solver="step" through K2, and a 3-cell corr_fading world with
     cell_coupling=0.5 on scan; traces equal to the device="cpu" run,
     losses within 1e-4 of it, K1 exactly once per fused run, K2 as often
     as the step driver iterates, K3 exactly as often as the traces imply
     (`hier_k3_expected`); then one warm 10-round scan run under
     torch.profiler and one under torch's sync debug mode;
  9. a run_many group as one batch on a leading cell axis, driven with
     every launch counter set to 0 just before it and read just after: the
     four paper DS policies x seeds 0-3 at `examples/torch_reproduce_figures.py`'s
     default widths (mnist MLP at full width, N 20, K 4, 500 samples) and
     5 rounds (depth cut to keep the script in its time), one 16-cell group on the
     scan engine and one with
     aggregation="async"; every cell bitwise its solo run on the card (all
     32), one cell per policy against the CPU, K1 once and K3 once per
     aggregation of the group, the group's host reads per round within the
     bound Σ over its policies of the most any of that policy's cells reads
     alone, plus one; the group's wall time beside the sum of the solo
     runs'; then a run_hier_many group as one batch on a config axis:
     phase 8's HierSimConfig at 10 rounds (2 cells x 10 devices x 4
     sub-channels, 400 samples, mnist MLP at full width) x the four paper
     DS policies x seeds 0-1, one 8-config group on the scan engine and
     one with aggregation="async" at both tiers; every config bitwise its
     solo run on the card (all 16), one config per policy against the CPU
     (traces exact, loss within 1e-4), K1 once per distinct world, K3
     exactly as the group rule and the traces imply (scan: per round one
     per cell index in which any config's cell trained, plus one global;
     async: rounds x (C + 1)), the group's host reads per (round, cell)
     within the flat bound carried to each cell index, and the group's
     wall time beside the sum of the solo runs'; the phase's wall time;
 10. the sweep harness and the sustained service, each driven with every
     launch counter set to 0 just before it and read just after:
     run_sweep at `examples/torch_reproduce_figures.py`'s default widths
     and 10 rounds (depth cut to keep the script in its time; mnist MLP at
     full width, N 20, K 4, 500 samples, the
     four paper DS policies x seeds 0 / 1 as that example's default,
     crossed with aggregation sync / async x cell counts 1 / 2: 32 cells,
     record and gallery into a temporary directory; its 16 hierarchical
     cells run as two run_hier_many groups), K1 and K3 launched as often
     as the spec and the traces imply (each group by its group rule), one
     cell per (aggregation, cell count) bitwise equal to its solo run on
     the card and its traces equal to the CPU's; then SustainedService at
     `python -m repro_torch.service.run --ra mo`'s defaults (N 64, K 16,
     128 samples, batch 16, churn; one warm-up and 2 measured segments of
     100 events, closed loop): events/s, p50/p95/p99 commit latency, SLO
     attainment, K1 once per segment, K3 once per event, host reads per
     event, and a 10-event segment of a fresh service (its third) under
     torch.profiler (K1's device ms and the idle share); on fresh services
     2 chained segments of 25 events
     bitwise equal to one of 50 and that one equal to the CPU's
     (traces exact, latency within 1e-6, loss within 1e-4), one segment
     with ra_solver="step" (K2) dispatching as the fused one, and one
     open-loop segment of 25 events at half the closed loop's events/s;
     K1 against its
     plain version, its bound and critical path at the hierarchy's and
     the service's pairs;
     every number beside the card's name and power limit, and the wall
     time of each sub-step of the sweep and of the service;
 10b. the Γ solver's projection backends: Γ of the main path's pairs and of
     the service segment's, by the step driver with "newton", "mixed" and
     "bisect" on the card, each against the same on the CPU (iterations
     equal) and against K1 on the card (iterations equal), values within
     RA_LIMITS, K1 and K2 launched 0 times; the Γ wall ms of K1, of K2
     through the step driver and of the three plain backends at both pair
     sets, beside the card's name and power limit; then, each driven with
     every launch counter set to 0 just before it and read just after and
     held against the same run on the CPU (traces equal, latency within
     1e-6, loss within 1e-4): run_simulation(SimConfig(rounds=30),
     engine="scan", ra_backend="mixed"), 10 rounds with ra_backend="newton"
     and ra_solver="step" (loop engine), and the hierarchy's scan engine
     (HierSimConfig(rounds=30)) with ra_backend="mixed"; K1 and K2 launched
     0 times and K3 once per aggregation; the phase's wall time;
 11. the serving paths: serve_loop at full width and depth (random weights
     from a seed) for qwen2-7b with attn_impl="pallas" and for rwkv6-7b
     with rwkv_wkv_impl="pallas", batch 4, prompt 512, 32 new tokens, the
     launch counters set to 0 just before each and read just after (K4
     exactly 28, K5 exactly 1 088); prefill logits within 4e-2 of the
     "ref" path on the same weights on the card, tokens in range, logits
     finite; a second, warm run under torch's sync debug mode (no host
     sync inside the decode loop) and a third, of 4 new tokens, under
     torch.profiler;
 12. four more archs of the zoo, each freed before the next loads, the
     largest last: serve_loop as in phase 11 (kernel path, batch 4, prompt
     512, 32 new tokens, counters set to 0 just before and read just after)
     for granite-moe-3b-a800m (32 layers, the MoE FFN on each), stablelm-3b
     (32, K4 at D 80) and yi-6b (32) at full depth and qwen1.5-110b at 16
     of its 80 layers (80 do not fit one card), K4 exactly once per layer;
     parameter count, memory allocated, prefill tok/s and decode ms/step;
     prefill logits against "ref" (granite's routing-aware: per layer the
     share of (token, slot) choices that agree, at least 0.99 at the first
     MoE layer and at every layer the floor that plain K4 against "ref"
     shows in the same run, less 0.02; the logits within 4e-2 on the rows
     routed alike at every layer and against "ref" routed as the kernel
     path routed); for
     granite also a warm run under sync debug (no host sync in the model's
     code) and a profiled run (idle share, the MoE's share of device time
     and its launches per step); the phase's wall time;
 13. MLA and Mamba: one full-width MLA layer of deepseek-v3-671b (prefill
     B 1 x S 512, one naive and one absorbed decode step) and one
     full-width Mamba layer of jamba-v0.1-52b (prefill B 1 x S 512, one
     decode step) on the card against the port's CPU path from the same
     weights and inputs (2e-2 of the scale, bf16); then, each freed before
     the next loads, serve_loop as in phase 11 (kernel path, batch 4,
     prompt 512, 32 new tokens, counters set to 0 just before and read
     just after) for deepseek-v3-671b at 5 of its 61 layers (3 dense + 2
     MoE), served twice from the same weights, naive and absorbed MLA
     decode (K4 exactly 0: MLA attends through the plain path), and
     jamba-v0.1-52b at 8 of its 32 layers (one period; K4 exactly 1, its
     attention layer); parameter count, memory after init and at peak, prefill
     tok/s, decode ms/step; prefill logits against "ref" routing-aware as
     phase 12 (for the hybrid, on the tokens whose whole prefix was routed
     alike, since the Mamba scan carries every earlier token); a warm run
     of each under sync debug (no host sync in the decode loop) and a
     4-token profiled run (idle share, kernels per prefill and per decode
     step, per MoE and per Mamba call); the phase's wall time;
 14. the audio and VLM families: K4 against its plain version at their
     prefill shapes, whisper-base's decoder (B 4, S 512, 8/8 heads, D 64)
     and qwen2-vl-2b's (12/2 heads, D 128), bf16 and f32, each with its
     time, bound and SDPA's; one full-width whisper-base decoder sublayer
     (self-attention through K4, then cross-attention over 1 500 encoder
     frames; prefill B 4 x S 512 and one decode step), one whisper-base
     encoder layer (B 4 x 1 500 frames, non-causal) and one qwen2-vl-2b
     attention layer on a 3-D M-RoPE grid (prefill and one decode step) on
     the card against the port's CPU path from the same weights and inputs
     (2e-2 of the scale, bf16); then serve_loop as in phase 11 (kernel
     path, batch 4, prompt 512, 32 new tokens, counters set to 0 just
     before and read just after) for whisper-base (6 encoder + 6 decoder
     layers, stub zero frames; K4 exactly 6, the decoder's self-attention)
     and qwen2-vl-2b (28 layers, stub zero patches and arange M-RoPE; K4
     exactly 28); prefill logits against "ref" on seeded random frames, or
     random patch embeddings (scale 0.02) on a 3-D grid; a warm run of
     each under sync debug (no host sync in the decode loop) and a
     4-token profiled run; the phase's wall time;
 15. the training path: train_loop(fl=True) — the Stackelberg planner's
     cohort weights in the loss, AdamW on the donated step (parameters and
     moments updated in place), train_loop's batch 8, lr 3e-4 — at full
     width with the depth cut (qwen2-7b at 4 layers for 10 steps, rwkv6-7b
     at 2 for 8, and for 8 steps each deepseek-v3-671b at its 3 dense
     layers with the MTP head, jamba-v0.1-52b at 2 (Mamba with the dense
     and with the MoE FFN), whisper-base at 6 + 6, qwen2-vl-2b at 28 on
     seq 512 and seeded patch embeddings, granite-moe-3b-a800m at its full
     32, stablelm-3b and yi-6b at their full 32; seq 128 for the rest;
     yi-6b for 12 steps), then for 10 steps at lr 1e-5 the dry run's train
     step, make_train_step(cfg, make_optimizer(cfg.optimizer), donate=True)
     with remat, the donated Adafactor, through the same loop:
     deepseek-v3-671b at 4 layers (its first MoE layer, with the MTP head),
     jamba-v0.1-52b at 5 (its attention layer) and qwen1.5-110b at 10 of
     80; random
     weights from a seed, the launch counters set to 0 just before each and
     read just after (none launches: training runs the "ref" paths), under
     torch's sync debug mode: parameter count, warm ms/step, tokens/s,
     model TFLOP/s (6 * params * tokens / time, and the cost model's
     `model_flops` train_total / time) and its share of the bf16 peak,
     max_memory_allocated, host syncs per step and the loss trace, which
     must be finite and fall (mean of the last 3 below that of the first
     3); qwen2-7b's and rwkv6-7b's runs again on the functional step
     (donate=False), their loss and grad-norm traces bitwise equal; a warm
     step and the optimizer's in-place update alone (AdamW or Adafactor,
     on gradients in the parameters' dtype with a clip scale) under
     torch.profiler; three AdamW steps of make_train_step(donate=True)
     bitwise equal to donate=False (every parameter, both moments, the
     count, the metrics) on the four families' smoke configs and qwen2-7b
     at full width with 1 layer, and three Adafactor steps likewise on
     those and jamba-v0.1-52b at full width with 2 layers (the meshed
     donated Adafactor runs in phase 18); one make_train_step with sgd on
     the card and on the CPU from
     the same weights (loss within 1e-2, grad norm within 2e-2 relative)
     for qwen2-7b at full width, 1 layer, batch 1, seq 32 (and remat=True
     against remat=False on the card) and the four families' smoke
     configs; examples/torch_train_100m.py --steps 10 --ckpt-every 5 into
     a temporary directory, its checkpoint restored bitwise; every number
     beside the card's name and power limit;
 16. the dry run against the card, with no card run of its own: the
     port's meta-device prediction (`repro_torch.launch`: `param_shapes`,
     `specs.cache_specs`, `dryrun.analyze`, `analytic`) of every arch
     phases 11-14 served, at its served depth and shape, and of the twelve
     training runs of phase 15 (the donated step, with its optimizer and
     remat), held to what those phases measured:
     parameter and cache bytes equal to the real tensors' exactly,
     memory_allocated's growth over init_params (and, for training, over
     init_params, the optimizer's init and one step) within 1% + 64 MiB of
     the predicted bytes; for the six runs since the donated Adafactor
     max_memory_allocated at most the predicted peak (arguments + temp)
     plus 1% + 64 MiB; printed beside the card's name and power limit, not
     gated: the predicted peak against max_memory_allocated for the other
     runs, the counted FLOPs against `model_flops`, and
     qwen2-7b's warm prefill time as a share of `analytic_cost`'s bound;
     the phase's wall time;
 18. across devices (run before the kernel list, which stays last): the
     Γ solve row-sharded (`shard=True`) over 1, 2 and 3 emulated shards of
     cuda:0 (`launch.mesh.emulate_devices`) at 77 x (3, 4) rows, the main
     path's 883 pairs and a service segment's 44 823, on K1 and on
     "mixed": every field bitwise the unsharded solve, K1 launched once
     per shard; phase 9's 16-cell `run_many` groups and 8-config
     `run_hier_many` groups (scan and async) with shard=True over 2
     emulated shards, every member bitwise phase 9's unsharded group run
     (reused), K1 once per shard per Γ solve and K3 as each block's traces
     imply; the meshed model as a world of one (NCCL, a (1, 1) mesh):
     granite-moe-3b-a800m at full width and 16 layers, one
     `multidevice_demo.run_rank` step through the expert-parallel MoE and
     `sharded_causal_attention` against the unsharded donated step from
     the same weights (loss within 1e-5, parameters within 2.5 lr), the
     meshed gradient (`train_step.make_grad_fn`) against the unsharded
     one leaf by leaf (1e-3 of each leaf's norm, the gradient norm 1e-5),
     no kernel launched on it, the dry run's peak beside
     max_memory_allocated, one meshed Adafactor step (its sharded form)
     donated bitwise the functional one (phase 15's part (d)), then four
     demo steps; each part's wall time;
 19. the production mesh (run before the kernel list): (a) in phase 18's
     world-of-one NCCL group, the meshed serving steps
     (`make_prefill_step` / `make_serve_step` with a (1, 1) `ShardCtx`:
     the layers on this rank's blocks, the cache in `cache_shardings`'
     layout and its flash-decoding combine) for granite-moe-3b-a800m at
     phase 18's width and depth, then rwkv6-7b at full width and 4 layers
     through K5, each a prefill and four greedy decode steps, held bitwise
     to the unmeshed steps on the card (tokens, logits, every cache leaf),
     the meshed decode ms/step beside the unmeshed; no kernel launched on
     granite's meshed path, K5 on rwkv6-7b's exactly once per layer per
     prefill and step (phase 6 holds K5 at the meshed path's head block,
     4 x 512 x 4 x 64, against its plain version); (b) in a subprocess (its fake process
     group cannot share a process with the NCCL group), the dry run on the
     production mesh, `python -m repro_torch.launch.dryrun --arch qwen2-7b
     --shape train_4k` on 16x16 (rank 0 of a fake 256-rank group, meta
     tensors): per-device arguments, temp, collective bytes by op and
     `fits`, gated against this card's total memory (started beside phase
     18, on the host's other cores); the phase's wall time;
 17. the kernel list as one JSON line (K4's launches per served arch,
     `serve_launches`, its D 80 check, `d80`, and its checks at
     whisper-base's and qwen2-vl-2b's shapes, `whisper_d64` and
     `qwen2_vl_d128`; K5's check at the meshed path's head block,
     `head_block`, and its launches on phase 19's meshed rwkv6-7b path,
     `mesh_launches`; with K1-K3's launches on the hierarchy's, the
     batched groups', the hierarchy groups', the sweep's, the service's
     and phase 10b's paths: `hier_launches`, `batch_launches`,
     `hier_batch_launches`, `sweep_launches`, `service_launches`,
     `ra_backend_launches`; every kernel's
     launches on the training path, `train_launches`; K1's bound at the
     hierarchy's and a service segment's pairs, `at`; K3's cell axis at 1,
     16 and 32 cells, `cells`; K1's launches per emulated shard count in
     phase 18, `shard_launches`).

Any failure raises; the last line is the device JSON only when every phase
passed.  Exits non-zero without a CUDA device or without the repository's
`src/` beside this file.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# Before the first allocation on the card: with expandable segments the
# caching allocator splits a block down to 512 bytes, so memory_allocated
# is the tensors' bytes; without them a large block whose remainder is at
# most 1 MiB is handed out whole (stablelm-3b's AdamW state: +372 MiB,
# 1.3% past the tensors, beyond phase 16's allowance).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.core import (PAPER_BASELINE_DS, RoundPolicy,  # noqa: E402
                              WirelessConfig, is_infeasible, total_energy)
from repro_torch.core.leader_torch import host_int  # noqa: E402
from repro_torch.core.monotonic_torch import solve_pairs_fused, solve_pairs_step  # noqa: E402
from repro_torch.fl import (HierSimConfig, SimConfig, run_hier_many,  # noqa: E402
                            run_hierarchical, run_simulation)
from repro_torch.experiments import SweepSpec, run_sweep  # noqa: E402
from repro_torch.fl import async_loop  # noqa: E402
from repro_torch.fl import hier_async  # noqa: E402
from repro_torch.fl import hierarchical as hier  # noqa: E402
from repro_torch.fl import run_many  # noqa: E402
from repro_torch.fl import sim as sim_mod  # noqa: E402
from repro_torch.fl.sim import _prepare  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.data.pipeline import synthetic_token_batch  # noqa: E402
from repro_torch.kernels.fedavg_agg import (  # noqa: E402
    fedavg_agg_plain, fedavg_agg_plain_cells, fedavg_aggregate, fedavg_aggregate_leaves,
    fedavg_aggregate_leaves_batched)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_plain  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import emulate_devices, split_padded  # noqa: E402
from repro_torch.launch.multidevice_demo import (demo_ctx, fl_batches, init_world,  # noqa: E402
                                                 leaf_gaps, run_rank)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.analytic import (GPU_HW, H100, _f_eval_ops,  # noqa: E402
                                         analytic_cost, bisect_step_ops, model_flops,
                                         projection_ops, select_fixed_ops)
from repro_torch.launch.specs import cache_specs  # noqa: E402
from repro_torch.launch.step_analysis import tree_nbytes  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.train.optimizer import adafactor, adamw, make_optimizer, sgd  # noqa: E402
from repro_torch.train.serve_step import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.train.train_step import make_grad_fn, make_train_step, mesh_optimizer  # noqa: E402
from repro_torch.train.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf_mod  # noqa: E402
from repro_torch.models.layers import mrope_grid  # noqa: E402
from repro_torch.models.transformer import (forward, init_params, param_count,  # noqa: E402
                                            param_specs)
from repro_torch.models.small import get_small_model  # noqa: E402
from repro_torch.scenarios import ScenarioStream  # noqa: E402
from repro_torch.launch.mesh import smoke_mesh  # noqa: E402
from repro_torch.sharding.ctx import ShardCtx  # noqa: E402
from repro_torch.sharding.params import shard_tree  # noqa: E402
from repro_torch.sharding.partition import leaves_with_path  # noqa: E402
from repro_torch.service import ServiceConfig, SustainedService  # noqa: E402
from repro_torch.kernels.polyblock_fused.ops import (  # noqa: E402
    LANES, coop_lanes, polyblock_solve_fused, polyblock_solve_plain)
from repro_torch.kernels.polyblock_project.ops import (  # noqa: E402
    polyblock_project, project_bisect, project_lanes)

DEV = torch.device("cuda", 0)
# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet, dense),
# from the port's cost model (launch/analytic.py): float64 34 TFLOP/s and
# float32 67 TFLOP/s outside the tensor cores (GPU_HW), bf16 989 TFLOP/s on
# them and HBM3 3.35 TB/s (H100).
PEAK_OPS = {torch.float64: GPU_HW.flops_f64, torch.float32: GPU_HW.flops_f32,
            torch.bfloat16: H100.peak_flops}
PEAK_BYTES = H100.hbm_bw
# Add-equivalent op counts of the cost model (OP_WEIGHTS prices a division
# at 4 and a log1p at 12): one evaluation of the objective f, one halving
# of the bisection, a projection's fixed part (the feasibility test, the
# final select and scaling), a selection's fixed part.
F_EVAL = _f_eval_ops().weighted()
BISECT_STEP = bisect_step_ops().weighted()
PROJ_FIXED = projection_ops("bisect", n_bisect=0).weighted()
SELECT_FIXED = select_fixed_ops().weighted()
EPS = 0.01
# K2 launches of the 10-round ra_solver="step" run: the first projection of
# (1, 1) and one children call per iteration of its slowest pair.
K2_STEP_LAUNCHES = 9
# The card's name and power limit (nvidia-smi), set by main() and printed
# beside the numbers of the sweep-and-service phase.
CARD = ""


def line(msg: str = "") -> None:
    print(msg, flush=True)


def phase_mark(n: int | str, t_all: float) -> None:
    line(f"phase {n} starts at {time.perf_counter() - t_all:.1f}s")


class Laps:
    """Wall seconds of a phase's sub-steps, printed on one line."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: list[tuple[str, float]] = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        self.t = now

    def print(self, what: str) -> None:
        line(f"{what} sub-steps wall_s: " + ", ".join(f"{n}={s:.1f}" for n, s in self.laps)
             + f" (sum {sum(s for _, s in self.laps):.1f}) [{CARD}]")


def time_ms(fn, reps: int, *, prefill: bool = False) -> float:
    """Mean time of one call, by CUDA events around `reps` calls.

    Without `prefill` the events also count any time the card waits for
    the host to enqueue the next launch.  With `prefill` the card first
    sleeps for longer than the host takes to enqueue all `reps` calls, so
    the events see the launches back to back: the device's own time.  It
    raises if the card reached the start event before the host had
    finished enqueueing (the queue was not full).  The sleep lasts at least
    ~20 ms, and garbage is collected first, so that a pause of the host
    (a collection after a profiled run) cannot drain the queue."""
    gc.collect()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # Clock cycles at no more than 2 GHz: the sleep lasts >= 3x host_s.
        torch.cuda._sleep(int(host_s * 3 * 2e9) + 40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if prefill and start.query():
        raise AssertionError("time_ms(prefill=True): the queue ran dry; sleep longer")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def feasible_draw(n: int, seed: int, cfg: WirelessConfig):
    """n feasible (beta, h2) pairs drawn as the JAX package's kernel tests
    draw them: h2 ~ 3 Exp(1), beta ~ U{5..59}, Prop-1 infeasible dropped."""
    rng = np.random.default_rng(seed)
    h2 = rng.exponential(size=2 * n) * 3
    beta = rng.integers(5, 60, 2 * n).astype(np.float64)
    keep = ~is_infeasible(h2, cfg, np.full(2 * n, cfg.e_max_j))
    assert keep.sum() >= n, "not enough feasible pairs drawn"
    return beta[keep][:n], h2[keep][:n]


def feasible_pairs(beta, h2, e_max, cfg: WirelessConfig):
    """The Prop-1 feasible (beta, h2, e_max) of a (..., K, N) block of
    pairs, flattened; beta and e_max broadcast against h2."""
    beta = np.broadcast_to(beta, h2.shape).reshape(-1)
    e_max = np.broadcast_to(e_max, h2.shape).reshape(-1)
    h2 = h2.reshape(-1)
    keep = ~is_infeasible(h2, cfg, e_max)
    return beta[keep], h2[keep], e_max[keep]


def main_path_pairs(cfg: SimConfig):
    """The feasible (beta, h2, e_max) pairs the simulation's Γ solve hands
    the kernels: its (rounds, K, N) horizon, Prop-1 filtered, flattened."""
    prep = _prepare(cfg, torch.device("cpu"))
    return (*feasible_pairs(prep.beta[None, None, :], prep.h2_all,
                            prep.emax_all[:, None, :], prep.wcfg), prep.wcfg)


# ---------------------------------------------------------------------------
# K2: the projection
# ---------------------------------------------------------------------------

def k2_ops(v, beta, h2, e_max, cfg) -> float:
    """Operations this data needs: every vertex is tested; only the ones
    outside G run their 60 halvings."""
    need = (project_need(v, beta, h2, e_max, cfg)).sum().item()
    return v.shape[0] * PROJ_FIXED + need * 60 * BISECT_STEP


def project_need(v, beta, h2, e_max, cfg):
    """Which vertices lie outside G (g > 0) and so need a root."""
    return total_energy(v[:, 0], v[:, 1], beta, h2, cfg) - e_max > 0


def k2_chain(v, beta, h2, e_max, cfg, lanes: int, n_bisect: int = 60) -> int:
    """Dependent evaluations of g on the longest vertex's chain: the vertex
    test, then, outside G, n_bisect halvings one after the other on one
    lane, or ceil(n_bisect / d) speculative rounds on L = 2^d lanes (an
    upper bound: a settled bracket evaluates no more)."""
    if not bool(project_need(v, beta, h2, e_max, cfg).any()):
        return 1
    return 1 + (n_bisect if lanes == 1 else -(-n_bisect // (lanes.bit_length() - 1)))


def k2_schedules(args, cfg, label: str, reps: int) -> dict[int, float]:
    """Every schedule (LANES) held to the one-lane schedule's bits, then
    timed (CUDA events, queue prefilled): {lanes: ms}."""
    one_lane = polyblock_project(*args, cfg, lanes=1)
    times = {}
    for lanes in LANES:
        res = polyblock_project(*args, cfg, lanes=lanes)
        torch.cuda.synchronize()
        if not torch.equal(res, one_lane):
            raise AssertionError(f"K2 {label}: lanes={lanes} differs from the one-lane "
                                 "schedule")
        times[lanes] = time_ms(lambda: polyblock_project(*args, cfg, lanes=lanes), reps,
                               prefill=True)
    return times


def check_k2(v64, beta64, h264, e64, cfg, label: str, reps: int) -> dict:
    """float64: within 1e-10 relative of the plain version (log1p's last ulp
    and torch's reciprocal-multiply division by a scalar are the only
    differences).  float32: the root is resolved only to float32 noise,
    whose tail at 2^18 vertices exceeds the JAX package's small-batch 1e-4
    contract for the plain version as well; so the kernel must be no less
    accurate than the plain float32 version against the float64 one (its
    worst error at most 2x the plain version's).

    Then every schedule (LANES: one thread per vertex, 4, 8 and 16 lanes
    per vertex) must give the one-lane schedule's bits, and each is timed
    in this run (CUDA events, queue prefilled) beside its critical path:
    its `k2_chain` at the latency per evaluation the one-lane time implies.
    The wrapper's own choice (`project_lanes`) is also timed as called,
    host enqueue included."""
    out = {}
    p64 = None
    n = v64.shape[0]
    for dtype in (torch.float64, torch.float32):
        args = [x.to(dtype).contiguous() for x in (v64, beta64, h264, e64)]
        got = polyblock_project(*args, cfg)
        want = project_bisect(*args, cfg)
        torch.cuda.synchronize()
        r = rel(got, want)
        if dtype == torch.float64:
            p64 = want
            ok, verdict = r < 1e-10, f"max_rel(zeta*v)={r:.3e} (limit 1e-10)"
        else:
            e_k, e_p = rel(got, p64), rel(want, p64)
            ok = e_k <= 2 * e_p
            verdict = (f"max_rel vs plain f32={r:.3e}; vs plain f64: kernel {e_k:.3e}, "
                       f"plain f32 {e_p:.3e} (limit: kernel <= 2x plain)")
        sched = {lanes: (ms_l, k2_chain(*args, cfg, lanes))
                 for lanes, ms_l in k2_schedules(args, cfg, f"{label} {dtype}", reps).items()}
        per_call_ns = sched[1][0] / sched[1][1] * 1e6
        chosen = project_lanes(n)
        ms = sched[chosen][0]
        host_ms = time_ms(lambda: polyblock_project(*args, cfg), reps)
        plain_ms = time_ms(lambda: project_bisect(*args, cfg), max(1, reps // 10))
        ops = k2_ops(*args, cfg)
        nbytes = n * 7 * args[0].element_size()
        b_ms, b_by = bound_ms(ops, nbytes, dtype)
        max_abs = float((got - want).abs().max())
        line(f"K2 {label} {str(dtype)[6:]}: n={n} {verdict} max_abs={max_abs:.3e} "
             f"lanes={chosen} kernel_ms={ms:.4f} kernel_ms_with_host_enqueue={host_ms:.4f} "
             f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
             f"critical_path_ms={sched[chosen][1] * per_call_ns * 1e-6:.4f} "
             f"speedup_vs_plain={plain_ms / ms:.1f}x")
        line(f"  schedules, bitwise equal to lanes=1: True; latency per evaluation of g "
             f"(lanes=1 ms / its chain) {per_call_ns:.1f} ns; "
             + "; ".join(f"lanes={k}: kernel_ms={v[0]:.4f} chain={v[1]} "
                         f"critical_path_ms={v[1] * per_call_ns * 1e-6:.4f}"
                         for k, v in sched.items()))
        if not ok:
            raise AssertionError(f"K2 {label} {dtype}: kernel disagrees with plain")
        # Evaluations of g this data needs: every vertex's test, and 60
        # halvings for each vertex outside G.
        evals = n + int(project_need(*args, cfg).sum()) * 60
        out[dtype] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, lanes=chosen, evals=evals)
    return out


def sweep_k2(v64, beta64, h264, e64, cfg, label: str, sizes, reps: int) -> None:
    """Where wide speculation stops paying: every schedule timed (queue
    prefilled) on the first n vertices for each n in `sizes`, float64 and
    float32, each held bitwise to the one-lane schedule; the sizes the
    rule `project_lanes` is set from."""
    for dtype in (torch.float64, torch.float32):
        for n in sizes:
            args = [x[:n].to(dtype).contiguous() for x in (v64, beta64, h264, e64)]
            times = k2_schedules(args, cfg, f"sweep {label} n={n} {dtype}", reps)
            best = min(times, key=times.get)
            line(f"K2 sweep {label} {str(dtype)[6:]} n={n}: bitwise equal to lanes=1: True; "
                 + " ".join(f"lanes={k}: {v:.4f}" for k, v in times.items())
                 + f" ms; fastest lanes={best}; rule project_lanes={project_lanes(n)}")


def k2_sass_bound(evals: int) -> None:
    """K2's bound priced from the card's instruction count instead of the
    JAX cost model's add-equivalents: the FP64-pipe instructions (DADD,
    DMUL, DFMA, DSETP, DMNMX) in the SASS of the one-lane
    `project_kernel<double>`, over its two inlined evaluations of g (the
    vertex test and the loop body: the two call sites of energy() in
    project()), at the card's FP64 issue rate (one instruction per FP64
    lane per clock: PEAK_OPS / 2, an FMA being two operations).  A static
    count, so an upper estimate: both sides of log1p's branches and the
    divisions' slow paths are in it."""
    ops = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "MUFU")
    counts = _build.sass_opcodes("polyblock", ops)
    for fn, c in counts.items():
        if "project" in fn:
            line(f"K2 SASS, {fn}: " + " ".join(f"{op}={k}" for op, k in c.items()))
    one = [c for fn, c in counts.items() if "project_kernelIdE" in fn]
    if not one:
        raise AssertionError("K2 SASS: project_kernel<double> not found")
    per_eval = sum(one[0][op] for op in ops[:-1]) / 2
    b_ms = evals * per_eval / (PEAK_OPS[torch.float64] / 2) * 1e3
    line(f"K2 SASS bound (main path f64): {per_eval:.1f} FP64-pipe instructions per "
         f"evaluation of g (project_kernel<double>, 2 inlined); {evals} evaluations this "
         f"data needs -> bound_ms={b_ms:.6f} at {PEAK_OPS[torch.float64] / 2:.3g} FP64 "
         "instructions/s")


def children_of_first_iteration(beta, h2, e_max, cfg):
    """The vertices K2 projects in the step driver's first children call:
    both eq.-23 children of every feasible pair's projected (1, 1)."""
    one = torch.ones(beta.shape[0], 2, dtype=beta.dtype, device=beta.device)
    phi = project_bisect(one, beta, h2, e_max, cfg)
    c1 = torch.stack([phi[:, 0], one[:, 1]], -1)
    c2 = torch.stack([one[:, 0], phi[:, 1]], -1)
    cat = lambda x: torch.cat([x, x])
    return torch.cat([c1, c2]), cat(beta), cat(h2), cat(e_max)


# ---------------------------------------------------------------------------
# K1: the whole solve
# ---------------------------------------------------------------------------

def k1_ops(beta, h2, e_max, iters, cfg) -> float:
    """Operations this data needs, from the solve's own iteration counts:
    a pair makes 1 + 2 * iters projections and objective evaluations and
    iters + 1 selections over its written slots; its projections run their
    halvings only when its (1, 1) vertex lies outside G (the children of a
    vertex outside G lie outside G too: g increases in tau and p, eq. 22)."""
    one = torch.ones(beta.shape[0], 2, dtype=beta.dtype, device=beta.device)
    need0 = project_need(one, beta, h2, e_max, cfg).double()
    it = iters.double()
    proj = 1 + 2 * it
    ops = proj * (PROJ_FIXED + F_EVAL) + need0 * proj * 60 * BISECT_STEP
    ops = ops + (it + 1) * SELECT_FIXED + (it + 1) * (it + 2) / 2
    return float(ops.sum())


def trajectory(got, want):
    """Share of pairs on the reference's trajectory (same iteration count),
    the worst relative error of (tau, p, T) on them, and the worst |dT| on
    the rest."""
    same = got[3] == want[3]
    errs = [rel(g[same], w[same]) for g, w in zip(got[:3], want[:3])]
    rest = ~same
    dt = float((got[2][rest].double() - want[2][rest].double()).abs().max()) \
        if rest.any() else 0.0
    return float(same.double().mean()), errs, dt, int(rest.sum())


def fmt(share, errs, dt, n_rest) -> str:
    return (f"same_trajectory={share:.6f} ({n_rest} differ) "
            f"max_rel_same(tau,p,T)=({errs[0]:.2e},{errs[1]:.2e},{errs[2]:.2e}) "
            f"max_abs_dT_rest={dt:.2e}")


def chain_calls(beta, h2, e_max, iters, cfg, lanes: int, n_bisect: int = 60) -> int:
    """Dependent evaluations of g on the longest pair's serial chain: one
    lane per pair runs 1 + 2 * iters projections one after the other,
    2L lanes run the two children of an iteration at once (1 + iters deep)
    and 60 halvings in ceil(60 / d) speculative rounds (L = 2^d); each
    projection first tests its vertex, and halves only outside G.  The
    cooperative count is an upper bound: its rounds evaluate nothing once
    the bracket settles at float precision (~24 halvings in float32, ~53 in
    float64)."""
    one = torch.ones(beta.shape[0], 2, dtype=beta.dtype, device=beta.device)
    need0 = project_need(one, beta, h2, e_max, cfg).long()
    it = iters.long()
    if lanes == 1:
        calls = (1 + 2 * it) * (1 + need0 * n_bisect)
    else:
        d = lanes.bit_length() - 1
        calls = (1 + it) * (1 + need0 * -(-n_bisect // d))
    return int(calls.max())


def check_k1(beta64, h264, e64, cfg, label: str, reps: int, bulk_iters: int = 0) -> dict:
    """float64: against the plain float64 version under the trajectory
    contract of the JAX package's float32 study (tests/test_kernels.py) —
    > 97% of pairs on its trajectory, within 1e-9 relative there, |dT| <= eps
    on the rest.  float32: > 97% of pairs on the plain float32 version's
    trajectory, and T within 1e-2 relative of the plain float64 version on
    every pair.  The float32 study's tighter terms (1e-4 on tau and p,
    |dT| <= eps off trajectory) hold on its 140-pair grid but not at 10^5
    pairs, for the plain float32 version as much as for the kernel: float32
    noise moves tau and p of flat optima by percents and re-routes a few
    slow pairs (T ~ 10^3 s) to a stop up to ~2.5e-3 away.

    Then every schedule (LANES: one thread per pair, 4, 8 and 16 lanes per
    child) must give the one-lane schedule's bits, and each is timed in
    this run (CUDA events, queue prefilled) beside its critical path: its
    `chain_calls` at the latency per evaluation the one-lane time implies.
    With `bulk_iters`, the chosen and the one-lane schedules are timed once
    more with every pair cut at that many iterations: the batch's bulk
    without its few long pairs' chains."""
    out = {}
    p64 = None
    for dtype in (torch.float64, torch.float32):
        args = [x.to(dtype).contiguous() for x in (beta64, h264, e64)]
        got = polyblock_solve_fused(*args, cfg)
        want = polyblock_solve_plain(*args, cfg)
        torch.cuda.synchronize()
        share, errs, dt, n_rest = trajectory(got, want)
        verdict = f"vs plain {str(dtype)[6:]}: " + fmt(share, errs, dt, n_rest)
        if dtype == torch.float64:
            p64 = want
            ok = share > 0.97 and max(errs) < 1e-9 and dt <= EPS + 1e-6
            verdict += " (limits: > 0.97, 1e-9, eps)"
        else:
            t_rel = rel(got[2], p64[2])
            ok = share > 0.97 and t_rel < 1e-2
            verdict += (f" (limit: > 0.97); T vs plain f64 max_rel={t_rel:.2e} (limit 1e-2); "
                        "plain f32 vs plain f64: " + fmt(*trajectory(want, p64)))
        max_abs = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got[:3], want[:3]))
        one_lane = polyblock_solve_fused(*args, cfg, lanes=1)
        sched = {}
        for lanes in LANES:
            res = polyblock_solve_fused(*args, cfg, lanes=lanes)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(res, one_lane))
            if not bitwise:
                raise AssertionError(f"K1 {label} {dtype}: lanes={lanes} differs from "
                                     "the one-lane schedule")
            ms_l = time_ms(lambda: polyblock_solve_fused(*args, cfg, lanes=lanes), reps,
                           prefill=True)
            sched[lanes] = (ms_l, chain_calls(*args, got[3], cfg, lanes))
        per_call_ns = sched[1][0] / sched[1][1] * 1e6
        chosen = coop_lanes(beta64.shape[0])
        ms = sched[chosen][0]
        plain_ms = time_ms(lambda: polyblock_solve_plain(*args, cfg), 1)
        ops = k1_ops(*args, got[3], cfg)
        nbytes = beta64.shape[0] * (6 * args[0].element_size() + 4)
        b_ms, b_by = bound_ms(ops, nbytes, dtype)
        crit_ms = sched[chosen][1] * per_call_ns * 1e-6
        line(f"K1 {label} {str(dtype)[6:]}: pairs={beta64.shape[0]} {verdict} "
             f"mean_iters={float(got[3].double().mean()):.3f} max_iters={int(got[3].max())} "
             f"lanes={chosen} kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} "
             f"bound_ms={b_ms:.5f} ({b_by}) critical_path_ms={crit_ms:.4f} "
             f"speedup_vs_plain={plain_ms / ms:.1f}x")
        line(f"  schedules, bitwise equal to lanes=1: True; latency per evaluation of g "
             f"(lanes=1 ms / its chain) {per_call_ns:.1f} ns; "
             + "; ".join(f"lanes={k}: kernel_ms={v[0]:.4f} chain={v[1]} "
                         f"critical_path_ms={v[1] * per_call_ns * 1e-6:.4f}"
                         for k, v in sched.items()))
        if bulk_iters:
            cut = []
            for lanes in (chosen, 1):
                cut_ms = time_ms(lambda: polyblock_solve_fused(
                    *args, cfg, max_iter=bulk_iters, lanes=lanes), reps, prefill=True)
                cut.append(f"lanes={lanes}: kernel_ms={cut_ms:.4f}")
            line(f"  bulk alone, every pair cut at max_iter={bulk_iters}: " + "; ".join(cut))
        if not ok:
            raise AssertionError(f"K1 {label} {dtype}: kernel disagrees with plain")
        out[dtype] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, lanes=chosen)
    return out


# ---------------------------------------------------------------------------
# K3: the eq.-34 weighted mean
# ---------------------------------------------------------------------------

def k3_weight_cases(k: int, gen) -> list[tuple[str, torch.Tensor]]:
    one = torch.zeros(k, device=DEV)
    one[k // 2] = 7.0
    return [("random", torch.rand(k, generator=gen, device=DEV) * 50 + 1),
            ("all_zero", torch.zeros(k, device=DEV)), ("one_slot", one)]


def check_k3(xs: list[torch.Tensor], label: str, reps: int, plain_reps: int) -> dict:
    """The kernel against its plain version on the (K, n_i) leaves `xs` of
    one aggregation (one grouped call, as the server makes it), for random,
    all-zero and single-slot weights.  Both make the same float32
    operations in the same order, so they must agree to the bit; all-zero
    weights must give exactly 0 and a single non-zero slot exactly that
    slot.  Times are for the whole aggregation: `ms`, `plain_ms` and
    `library_ms` (`torch.matmul` per leaf) are the card's own time (queue
    prefilled, see `time_ms`), `host_ms` the kernel's time as a caller sees
    it, host enqueue included; `per_leaf` the same leaves one call (and
    launch) each.  A prefilled timing keeps its launches (reps x launches
    per call) below ~1000, the depth of the card's launch queue: past it
    the host blocks, and the card catches up before the host has enqueued
    everything."""
    gen = torch.Generator(DEV).manual_seed(len(xs))
    k = xs[0].shape[0]
    max_abs = 0.0
    for case, w in k3_weight_cases(k, gen):
        before = fedavg_aggregate_leaves.launches
        got = fedavg_aggregate_leaves(xs, w)
        torch.cuda.synchronize()
        launches = fedavg_aggregate_leaves.launches - before
        for g, x in zip(got, xs):
            want = fedavg_agg_plain(x, w)
            err = float((g - want).abs().max())
            max_abs = max(max_abs, err)
            if not torch.equal(g, want):
                raise AssertionError(f"K3 {label} {case}: kernel differs from plain "
                                     f"(max_abs {err:.3e})")
            if case == "all_zero" and bool(g.any()):
                raise AssertionError(f"K3 {label}: all-zero weights did not give 0")
            if case == "one_slot" and not torch.equal(g, x[k // 2]):
                raise AssertionError(f"K3 {label}: one slot did not give that slot")
        if launches != 1:
            raise AssertionError(f"K3 {label}: {launches} launches for one aggregation")
    w = k3_weight_cases(k, gen)[0][1]
    w_hat = w / w.sum()
    host_ms = time_ms(lambda: fedavg_aggregate_leaves(xs, w), reps)
    ms = time_ms(lambda: fedavg_aggregate_leaves(xs, w), reps, prefill=True)
    leaf_host_ms = time_ms(lambda: [fedavg_aggregate(x, w) for x in xs], reps)
    leaf_ms = time_ms(lambda: [fedavg_aggregate(x, w) for x in xs], reps, prefill=True)
    plain_ms = time_ms(lambda: [fedavg_agg_plain(x, w) for x in xs], plain_reps,
                       prefill=True)
    library_ms = time_ms(lambda: [torch.matmul(w_hat, x) for x in xs], reps, prefill=True)
    n_total = sum(x.shape[1] for x in xs)
    b_ms, b_by = bound_ms(2 * k * n_total, (k + 1) * n_total * 4, torch.float32)
    line(f"K3 {label}: K={k} N={'+'.join(str(x.shape[1]) for x in xs)} launches=1 "
         f"max_abs_err={max_abs:.3e} bitwise_equal_plain=True kernel_ms={ms:.4f} "
         f"kernel_ms_with_host_enqueue={host_ms:.4f} "
         f"plain_ms={plain_ms:.4f} library_ms(matmul)={library_ms:.4f} "
         f"bound_ms={b_ms:.5f} ({b_by}) achieved_GB/s={(k + 1) * n_total * 4 / ms / 1e6:.1f}")
    if len(xs) > 1:
        line(f"  per leaf, one launch each ({len(xs)} launches): kernel_ms={leaf_ms:.4f} "
             f"kernel_ms_with_host_enqueue={leaf_host_ms:.4f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def k3_cell_weights(cells: int, k: int, gen) -> torch.Tensor:
    """(cells, k) weights cycling through random, all-zero and single-slot
    cells."""
    w = torch.rand(cells, k, generator=gen, device=DEV) * 50 + 1
    w[1::3] = 0.0
    w[2::3] = 0.0
    w[2::3, k // 2] = 7.0
    return w


def check_k3_cells(shapes: list[tuple], cells: int, reps: int) -> dict:
    """K3's cell axis (`fedavg_aggregate_leaves_batched`) on the leaves of
    `cells` cells' aggregations, K = 4, weights cycling through random,
    all-zero and single-slot cells: one launch for every cell, each cell
    bitwise its plain version and its own one-cell launch.  Times (CUDA
    events): the batched launch on the card (`ms`, queue prefilled) and as
    called (host enqueue included), the same aggregations one one-cell
    launch per cell (prefilled), the plain version as called (its
    launches outnumber the queue's depth), and `torch.bmm` per leaf as the
    library call; the bound: every stacked byte read and every mean written
    once, 2K operations per output."""
    gen = torch.Generator(DEV).manual_seed(cells)
    k = 4
    xs = [torch.randn((cells, k) + s, generator=gen, device=DEV) for s in shapes]
    w = k3_cell_weights(cells, k, gen)
    before = fedavg_aggregate_leaves_batched.launches
    got = fedavg_aggregate_leaves_batched(xs, w)
    torch.cuda.synchronize()
    launches = fedavg_aggregate_leaves_batched.launches - before
    max_abs = 0.0
    for c in range(cells):
        one = fedavg_aggregate_leaves([x[c] for x in xs], w[c])
        for g, x, o in zip(got, xs, one):
            want = fedavg_agg_plain(x[c], w[c])
            max_abs = max(max_abs, float((g[c] - want).abs().max()))
            if not (torch.equal(g[c], want) and torch.equal(g[c], o)):
                raise AssertionError(f"K3 cells={cells}: cell {c} differs from plain or "
                                     "from its one-cell launch")
    if launches != 1:
        raise AssertionError(f"K3 cells={cells}: {launches} launches for one aggregation "
                             "per cell")
    w_hat = w / w.sum(-1, keepdim=True).clamp_min(1e-30)
    ms = time_ms(lambda: fedavg_aggregate_leaves_batched(xs, w), reps, prefill=True)
    host_ms = time_ms(lambda: fedavg_aggregate_leaves_batched(xs, w), reps)
    per_cell_ms = time_ms(
        lambda: [fedavg_aggregate_leaves([x[c] for x in xs], w[c]) for c in range(cells)],
        max(1, 500 // cells), prefill=True)
    plain_ms = time_ms(lambda: [fedavg_agg_plain_cells(x, w) for x in xs], 2)
    library_ms = time_ms(lambda: [torch.bmm(w_hat[:, None, :], x.reshape(cells, k, -1))
                                  for x in xs], reps, prefill=True)
    n_total = sum(int(np.prod(s)) for s in shapes)
    nbytes = cells * ((k + 1) * n_total + k) * 4
    b_ms, b_by = bound_ms(2 * k * n_total * cells, nbytes, torch.float32)
    line(f"K3 cells={cells} (mnist MLP leaves, K={k}, one aggregation per cell): "
         f"launches={launches} max_abs_err={max_abs:.3e} bitwise_equal_plain=True "
         f"bitwise_equal_one_cell_launches=True kernel_ms={ms:.4f} "
         f"kernel_ms_with_host_enqueue={host_ms:.4f} one_cell_launches_ms={per_cell_ms:.4f} "
         f"({cells} launches) plain_ms_as_called={plain_ms:.4f} library_ms(bmm)="
         f"{library_ms:.4f} bound_ms={b_ms:.5f} ({b_by}) achieved_GB/s="
         f"{nbytes / ms / 1e6:.1f} [{CARD}]")
    return dict(cells=cells, max_abs_err=max_abs, ms=ms, host_ms=host_ms,
                one_cell_launches_ms=per_cell_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# K4: flash attention; K5: the WKV6 recurrence
# ---------------------------------------------------------------------------

def attn_pairs(sq: int, sk: int, window: int) -> int:
    """(query, key) pairs the causal (and window) mask leaves, per head."""
    i = torch.arange(sq, dtype=torch.int64)[:, None] + (sk - sq)
    j = torch.arange(sk, dtype=torch.int64)[None, :]
    keep = j <= i
    if window > 0:
        keep &= j > i - window
    return int(keep.sum())


def sdpa_call(q, k, v, window: int):
    """One PyTorch call for the same function, as a yardstick only: causal
    SDPA with GQA; an explicit boolean mask where the queries are
    right-aligned (Sq < Sk) or a window applies, since SDPA's is_causal
    aligns them top-left."""
    import torch.nn.functional as F
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    if sq == sk and window == 0:
        kw = dict(is_causal=True)
    else:
        i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=q.device)[None, :]
        kw = dict(attn_mask=(j <= i) & ((j > i - window) if window > 0 else True))
    # Output in the model's (B, S, H, D) layout, as a view.
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True,  # noqa: E731
                                                  **kw).transpose(1, 2)


def check_k4(b, sq, sk, hq, hkv, d, window, dtype, label: str, reps: int) -> dict:
    """The kernel against its plain version on random inputs: both take
    f32 scores, softmax and P.V and cast once, so f32 must agree to 1e-5
    and bf16 to one ulp (plus that 1e-5 floor near 0)."""
    gen = torch.Generator(DEV).manual_seed(sq * 7 + window)
    q = torch.randn(b, sq, hq, d, generator=gen, device=DEV).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=DEV).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=DEV).to(dtype)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    diff = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        ok, limit = bool(diff.max() <= 1e-5), "1e-5"
    else:
        mag = torch.maximum(got.double().abs(), want.double().abs()).clamp_min(2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok, limit = bool((diff <= ulp + 1e-5).all()), "1 bf16 ulp + 1e-5"
    lib = sdpa_call(q, k, v, window)
    lib_err = float((lib().double() - want.double()).abs().max())
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window), reps, prefill=True)
    host_ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window), reps)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal=True, window=window),
                       max(2, reps // 4), prefill=True)
    library_ms = time_ms(lib, reps, prefill=True)
    pairs = attn_pairs(sq, sk, window)
    elt = q.element_size()
    b_ms, b_by = bound_ms(4 * b * hq * d * pairs, (2 * b * sq * hq + 2 * b * sk * hkv) * d * elt,
                          dtype)
    max_abs = float(diff.max())
    line(f"K4 {label} {str(dtype)[6:]}: B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
         f"window={window} max_abs_err={max_abs:.3e} (limit {limit}) sdpa_max_abs_err="
         f"{lib_err:.3e} kernel_ms={ms:.4f} kernel_ms_with_host_enqueue={host_ms:.4f} "
         f"plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} bound_ms={b_ms:.5f} "
         f"({b_by}) achieved_TFLOP/s={4 * b * hq * d * pairs / ms / 1e9:.2f}")
    if not ok:
        raise AssertionError(f"K4 {label} {dtype}: kernel disagrees with plain")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def check_k5(b, t, h, hs, label: str, reps: int) -> dict:
    """The kernel against its plain version with random non-zero u and
    initial state: both make the same f32 operations in the same order, so
    they should agree to the bit; the gate is y and the final state within
    1e-5 of their scale."""
    gen = torch.Generator(DEV).manual_seed(t)
    r, k, v = (torch.randn(b, t, h, hs, generator=gen, device=DEV) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, t, h, hs, generator=gen, device=DEV) * 7 - 7))
    u = torch.randn(h, hs, generator=gen, device=DEV)
    s0 = torch.randn(b, h, hs, hs, generator=gen, device=DEV)
    y, s = wkv6(r, k, v, w, u, s0)
    y_p, s_p = wkv6_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    rel_y = float((y - y_p).abs().max() / y_p.abs().max())
    rel_s = float((s - s_p).abs().max() / s_p.abs().max())
    ms = time_ms(lambda: wkv6(r, k, v, w, u, s0), reps, prefill=True)
    host_ms = time_ms(lambda: wkv6(r, k, v, w, u, s0), reps)
    plain_ms = time_ms(lambda: wkv6_plain(r, k, v, w, u, s0), 2)
    # 7 flops per (t, i, j): k*v, u*kv, + S, r*(.), + y, w*S, + kv.
    b_ms, b_by = bound_ms(7 * b * t * h * hs * hs,
                          (5 * b * t * h * hs + 2 * b * h * hs * hs + h * hs) * 4, torch.float32)
    max_abs = max(float((y - y_p).abs().max()), float((s - s_p).abs().max()))
    bitwise = bool(torch.equal(y, y_p) and torch.equal(s, s_p))
    line(f"K5 {label}: B={b} T={t} H={h} hs={hs} rel_err(y)={rel_y:.3e} rel_err(state)="
         f"{rel_s:.3e} (limit 1e-5 of scale) bitwise_equal_plain={bitwise} "
         f"max_abs_err={max_abs:.3e} kernel_ms={ms:.4f} "
         f"kernel_ms_with_host_enqueue={host_ms:.4f} plain_ms={plain_ms:.4f} "
         f"library_ms=None bound_ms={b_ms:.5f} ({b_by})")
    if not (rel_y < 1e-5 and rel_s < 1e-5):
        raise AssertionError(f"K5 {label}: kernel disagrees with plain")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

class K3Launches:
    """K3's launches through either entry: one aggregation
    (`fedavg_aggregate_leaves`: the loop engine, the hierarchy's global
    tier) or one per cell of a group (`fedavg_aggregate_leaves_batched`:
    the scan and async engines).  Setting it sets both counts."""

    @property
    def launches(self) -> int:
        return fedavg_aggregate_leaves.launches + fedavg_aggregate_leaves_batched.launches

    @launches.setter
    def launches(self, value: int) -> None:
        fedavg_aggregate_leaves.launches = value
        fedavg_aggregate_leaves_batched.launches = 0


COUNTERS = {"polyblock_fused": polyblock_solve_fused,
            "polyblock_project": polyblock_project,
            "fedavg_agg": K3Launches(),
            "flash_attention": flash_attention,
            "rwkv6_wkv": wkv6}


def run_on_card(cfg, run=run_simulation, **kw):
    """One run of `run(cfg, device=DEV, **kw)` on the card with every
    launch counter (and the host-read counter) set to 0 just before it;
    returns its result, wall seconds, the launch counts and the host reads
    of that run."""
    for fn in COUNTERS.values():
        fn.launches = 0
    host_int.syncs = 0
    t0 = time.perf_counter()
    hist = run(cfg, device=DEV, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return hist, wall, {name: fn.launches for name, fn in COUNTERS.items()}, host_int.syncs


def run_name(run, kw: dict) -> str:
    """A run's label in the output: the entry point's keyword arguments,
    "hier" before them for the hierarchy."""
    name = " ".join(f"{k}={v}" for k, v in kw.items()) or "engine=loop"
    return name if run is run_simulation else "hier " + name


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300), initial=0.0))


def drive(cfg: SimConfig, need: tuple[str, ...], **kw) -> tuple:
    """Drive one main path on the card twice and once on the CPU; check the
    card's run against the CPU's and that each kernel in `need` launched."""
    hist, wall, launches, syncs = run_on_card(cfg, **kw)
    again, warm_wall, _, _ = run_on_card(cfg, **kw)
    t0 = time.perf_counter()
    ref = run_simulation(cfg, device="cpu", **kw)
    cpu_wall = time.perf_counter() - t0
    name = " ".join(f"{k}={v}" for k, v in kw.items()) or "engine=loop"
    line(f"main path {name} aggregation={cfg.aggregation} rounds={cfg.rounds}: launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; host reads={syncs} ({syncs / cfg.rounds:.2f} per round); gpu wall_s first "
         f"run={wall:.3f} (plan_wall_s={hist.plan_wall_s:.4f}), second run={warm_wall:.3f} "
         f"(plan_wall_s={again.plan_wall_s:.4f}); cpu wall_s={cpu_wall:.3f} "
         f"(plan_wall_s={ref.plan_wall_s:.4f})")
    line("  loss: " + " ".join(f"{x:.4f}" for x in hist.global_loss))
    line("  acc:  " + " ".join(f"{x:.3f}" for x in hist.accuracy))
    same = {f: np.array_equal(getattr(hist, f), getattr(ref, f))
            for f in ("tx_trace", "age_trace", "commit_trace")
            if getattr(ref, f) is not None}
    lat_rel = max_rel(hist.latency_all, ref.latency_all)
    loss_rel = max_rel(hist.global_loss, ref.global_loss)
    line("  " + "; ".join(f"{f} == cpu: {v}" for f, v in same.items())
         + f"; latency max_rel vs cpu: {lat_rel:.3e} (limit 1e-6); loss max_rel vs cpu: "
         f"{loss_rel:.3e} (limit 1e-4); transmissions: {int(hist.tx_trace.sum())}")
    for kernel in need:
        if launches[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the main path {name}")
    if not (np.all(np.isfinite(hist.global_loss)) and hist.global_loss.shape == (cfg.rounds,)):
        raise AssertionError("losses are not finite / not one per round")
    if not hist.global_loss[-1] < hist.global_loss[0]:
        raise AssertionError("training did not lower the loss")
    if not np.array_equal(again.tx_trace, hist.tx_trace):
        raise AssertionError("two runs of the same seed on the card differ in tx")
    if not all(same.values()):
        raise AssertionError("traces differ from the CPU run")
    if not (lat_rel <= 1e-6 and loss_rel <= 1e-4):
        raise AssertionError("latency or loss too far from the CPU run")
    return hist, launches


# The events that torch's own read-back leaves out (`_filter_name` in
# torch/autograd/profiler_util.py).
SKIPPED_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))
# A device event name of a profiled window: its events and their summed us.
Kernel = collections.namedtuple("Kernel", "key count us")


def read_trace(prof) -> tuple[list[Kernel], dict]:
    """A profiled window read from torch's raw events in one pass: the
    device events with device time, by name (`Kernel`), and for each range
    name that `is_range` accepts, (calls, kernels launched inside those
    ranges, their device us).  torch's own read-back (`key_averages()`,
    `events()`) sums by the same rules (`_parse_kineto_results` in
    torch/autograd/profiler.py): a device event's time is its end less its
    start, none if it is async; a kernel belongs to the frontend op whose
    correlation id it links; an op lies inside each range of its thread
    that spans it.  But it builds some thirty fields and a tree for every
    event, which took most of each profiled window's wall time
    (`examples/torch_smoke_parts.py --profile-readback` times both and
    holds them equal)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    sums: dict[str, list] = {}
    # Frontend ops by correlation id: [(thread, start, end)], every op of an id.
    ops: dict[int, list] = collections.defaultdict(list)
    ranges: list[tuple[str, int, int, int]] = []
    linked: list[tuple[int, float]] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in SKIPPED_EVENTS or getattr(e, "is_hidden_event", lambda: False)():
            continue
        dev = e.device_type()
        sync = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        if dev == cuda:
            us = (e.end_ns() - e.start_ns()) / 1e3
            slot = sums.setdefault(name, [0, 0.0])
            slot[0] += 1
            slot[1] += us if sync else 0.0
            if e.linked_correlation_id() > 0:
                linked.append((e.linked_correlation_id(), us))
        elif dev == cpu and sync and e.linked_correlation_id() == 0:
            span = (e.start_thread_id(), e.start_ns(), e.end_ns())
            ops[e.correlation_id()].append(span)
            if is_range(name):
                ranges.append((name,) + span)
    merged: dict[str, list] = {}
    for name, (count, us) in sums.items():
        key = torch._C._demangle(name) if len(name) > 1 else name
        slot = merged.setdefault(key, [0, 0.0])
        slot[0] += count
        slot[1] += us
    kernels = [Kernel(k, n, us) for k, (n, us) in merged.items() if us > 0]
    by_thread: dict[int, list] = collections.defaultdict(list)
    for corr, us in linked:
        for thread, start, end in ops.get(corr, ()):
            by_thread[thread].append((start, end, us))
    starts = {}
    for thread, rows in by_thread.items():
        rows.sort()
        starts[thread] = [r[0] for r in rows]
    inside: dict[str, tuple[int, int, float]] = {}
    for name, thread, start, end in ranges:
        rows, at = by_thread.get(thread, []), starts.get(thread, [])
        mine = [us for _, stop, us in
                rows[bisect.bisect_left(at, start):bisect.bisect_left(at, end)] if stop <= end]
        calls, n, us = inside.get(name, (0, 0, 0.0))
        inside[name] = (calls + 1, n + len(mine), us + sum(mine))
    return kernels, inside


def profile_call(name: str, fn, focus: tuple[str, ...] = ()) -> dict:
    """Where one warm call's time goes: `fn()` under torch.profiler: wall
    time, the card's busy time (the sum of its kernels' self time; one
    stream, so kernels do not overlap), its idle share, the kernel count,
    and the kernels that take most of it; for each name part in `focus`,
    the launches and summed device time of the kernels whose name holds
    it.  Returns the idle share and each focus part's device ms (None where
    the profiler saw no such kernel)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, _ = read_trace(prof)
    # The trace's processing and read-back, which the script waits for.
    readback = time.perf_counter() - t0 - wall
    busy_ms = sum(k.us for k in kernels) / 1e3
    if busy_ms == 0:
        line(f"profile {name}: wall_s={wall:.3f}; device time not measured (no device events)")
        return dict(idle=None, **{part: None for part in focus})
    idle = 1 - busy_ms / 1e3 / wall
    line(f"profile {name}: wall_s={wall:.3f} (profiled) device_busy_ms="
         f"{busy_ms:.2f} device_idle_share={idle:.4f} "
         f"kernel_launches={sum(k.count for k in kernels)}; trace read back in {readback:.1f}s")
    for k in sorted(kernels, key=lambda k: -k.us)[:6]:
        line(f"  {k.us / 1e3:8.3f} ms  {k.count:6d}x  {k.key[:90]}")
    out = dict(idle=idle)
    for part in focus:
        mine = [k for k in kernels if part in k.key]
        ms = sum(k.us for k in mine) / 1e3
        out[part] = ms if mine else None
        line(f"  kernels named *{part}*: launches={sum(k.count for k in mine)} device_ms="
             f"{ms:.4f} (" + ", ".join(f"{k.key[:60]} x{k.count}" for k in mine) + ")")
    return out


# Rounds of a profiled or sync-counted run (30 until the training phase
# took the donated Adafactor's runs): a profile's trace is read back kernel
# by kernel (a 30-round run took 6-11 s to read), and sync debug mode
# warns at every host read.
PROFILE_ROUNDS = 10


def profile_run(cfg, focus: tuple[str, ...] = (), run=run_simulation, **kw) -> None:
    """`profile_call` of one run of `run(cfg, device=DEV, **kw)` cut to
    PROFILE_ROUNDS rounds: a warm run, since every path profiled here has
    run on the card before."""
    cfg = dataclasses.replace(cfg, rounds=min(cfg.rounds, PROFILE_ROUNDS))
    profile_call(f"{run_name(run, kw)} rounds={cfg.rounds}",
                 lambda: run(cfg, device=DEV, **kw), focus)


# What torch's sync debug mode says of a synchronizing call (it also warns,
# once per process, that the mode is a prototype: that is not a sync).
SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_counted(fn):
    """fn() under torch's sync debug mode: (result, its synchronizing calls
    counted by source line)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if SYNC_WARNING in str(w.message)]
    return out, collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs)


def count_syncs(cfg, run=run_simulation, **kw) -> None:
    """Every host sync of one run of `run(cfg, device=DEV, **kw)`, as
    torch's sync debug mode reports them (one warning per synchronizing
    call), by the source line that made it, beside the engine's own count
    of its host reads (`host_int`), cut to PROFILE_ROUNDS rounds."""
    cfg = dataclasses.replace(cfg, rounds=min(cfg.rounds, PROFILE_ROUNDS))
    host_int.syncs = 0
    _, by_line = sync_counted(lambda: (run(cfg, device=DEV, **kw), torch.cuda.synchronize()))
    n = sum(by_line.values())
    name = run_name(run, kw)
    line(f"syncs {name} rounds={cfg.rounds}: {n} synchronizing calls "
         f"({n / cfg.rounds:.2f} per round); host_int reads={host_int.syncs}; "
         "by source line: " + ", ".join(f"{k} x{v}" for k, v in by_line.most_common(8)))


# ---------------------------------------------------------------------------
# the hierarchy's main paths (multi-cell)
# ---------------------------------------------------------------------------

def hier_sim(cfg: HierSimConfig, device, engine: str = "scan",
             ra_solver: str = "fused", ra_backend: str | None = None) -> dict:
    """One hierarchy run through the entry point a user calls
    (`run_hierarchical` for the loop engine, `run_hier_many` otherwise), as
    per-cell traces: tx and AoU (rounds, C, N), losses, latencies, the
    async engine's commits at both tiers, and the SimHistory (`hist`; None
    on the loop engine)."""
    if engine == "loop":
        out = run_hierarchical(cfg, engine="loop", ra_backend=ra_backend, device=device)
        return dict(tx=out["tx"], age=out["age"], loss=out["loss"], acc=out["accuracy"],
                    latency=out["latency"], hist=None)
    h = run_hier_many([cfg], engine=engine, ra_backend=ra_backend, ra_solver=ra_solver,
                      device=device)[0]
    shape = (cfg.rounds, cfg.n_cells, cfg.devices_per_cell)
    out = dict(tx=h.tx_trace.reshape(shape), age=h.age_trace.reshape(shape),
               loss=h.global_loss, acc=h.accuracy, latency=h.latency_all, hist=h)
    if h.commit_trace is not None:
        out.update(committed=h.commit_trace.reshape(shape),
                   cell_committed=h.async_trace["cell_committed"])
    return out


def hier_group_k3_expected(cfg: HierSimConfig, engine: str,
                           txs: list[np.ndarray]) -> tuple[int, str]:
    """The K3 launches of one `run_hier_many` group that its configs' tx
    traces ((rounds, C, N) each) imply, and how.  Every aggregation is one
    launch for all the group's configs.  scan: per round, one per cell
    index in which any config's cell trained, and a global one every round
    over every config's C cell slots.  async: the count does not depend on
    the traces, by design: every event makes one buffered commit per cell
    index and one at the global tier, for all configs, whether or not
    anything commits (a commit that takes nothing is an exact identity
    select, so the engine makes no host read to skip it), so rounds x
    (C + 1), whatever the group's size."""
    if engine == "async":
        return (cfg.rounds * (cfg.n_cells + 1),
                f"{cfg.rounds} events x ({cfg.n_cells} cells + 1 global)")
    trained = np.any([tx.any(axis=2) for tx in txs], axis=0)      # (rounds, C)
    return (int(trained.sum()) + cfg.rounds,
            f"{int(trained.sum())} cell + {cfg.rounds} global")


def hier_k3_expected(cfg: HierSimConfig, engine: str, out: dict) -> tuple[int, str]:
    """The K3 launches a run's traces imply, and how.  Every aggregation is
    one grouped K3 launch.  loop: one per (round, cell) in which the cell
    trained, and a global one per round in which any cell trained (it
    stacks only those cells); scan and async: the group rule
    (`hier_group_k3_expected`) of a group of one.  On async the check shows
    only that each event launched C + 1 aggregations; the cell-tier and
    global commits of the traces are printed beside it, and each is one of
    those launches."""
    trained = out["tx"].any(axis=2)                     # (rounds, C)
    if engine == "loop":
        any_t = int(trained.any(axis=1).sum())
        return int(trained.sum()) + any_t, f"{int(trained.sum())} cell + {any_t} global"
    want, how = hier_group_k3_expected(cfg, engine, [out["tx"]])
    if engine == "async":
        how += (f"; cell-tier commits {int(out['committed'].any(axis=2).sum())}, global "
                f"commits {int(out['cell_committed'].sum())}")
    return want, how


def hier_k2_expected(cfg: HierSimConfig) -> int:
    """K2 launches of a `ra_solver="step"` run: the step driver projects
    (1, 1) once, then the children once per iteration of its slowest pair
    (the iteration counts of the same solve on the CPU)."""
    prep = hier._prepare_hier(cfg, torch.device("cpu"))
    (ras,), _ = hier._solve_hier_horizons([prep], "step", torch.device("cpu"))
    return 1 + max(int(ra.iterations.max()) for ra in ras)


def drive_hier(cfg: HierSimConfig, engine: str, need: tuple[str, ...],
               ra_solver: str = "fused", ra_backend: str | None = None
               ) -> tuple[dict, dict]:
    """Drive one hierarchy path on the card twice and once on the CPU:
    traces equal to the CPU run's, latency within 1e-6 and losses within
    1e-4 of it, each kernel in `need` launched, K1 exactly once on a fused
    run, K2 as often as the step driver iterates on a step run (neither
    with a plain `ra_backend`), and K3 exactly as often as the traces imply
    (`hier_k3_expected`)."""
    kw = dict(engine=engine, ra_solver=ra_solver, ra_backend=ra_backend)
    out, wall, launches, syncs = run_on_card(cfg, hier_sim, **kw)
    again, warm_wall, _, _ = run_on_card(cfg, hier_sim, **kw)
    t0 = time.perf_counter()
    ref = hier_sim(cfg, "cpu", **kw)
    cpu_wall = time.perf_counter() - t0
    name = (f"engine={engine}" + (f" ra_solver={ra_solver}" if ra_solver != "fused" else "")
            + (f" ra_backend={ra_backend}" if ra_backend is not None else ""))
    line(f"main path hier {name} cells={cfg.n_cells}x{cfg.devices_per_cell} devices, "
         f"{cfg.subchannels_per_cell} sub-channels each, scenario={cfg.scenario} "
         f"coupling={cfg.cell_coupling} aggregation={cfg.aggregation}/"
         f"{cfg.global_aggregation} rounds={cfg.rounds}: launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; host reads={syncs} ({syncs / cfg.rounds:.2f} per round); gpu wall_s first "
         f"run={wall:.3f}, second run={warm_wall:.3f}; cpu wall_s={cpu_wall:.3f}"
         + (f"; plan_wall_s gpu={out['hist'].plan_wall_s:.4f} cpu={ref['hist'].plan_wall_s:.4f}"
            if out["hist"] is not None else ""))
    line("  loss: " + " ".join(f"{x:.4f}" for x in out["loss"]))
    line("  acc:  " + " ".join(f"{x:.3f}" for x in out["acc"]))
    same = {f: np.array_equal(out[f], ref[f])
            for f in ("tx", "age", "committed", "cell_committed") if f in ref}
    lat_rel = max_rel(out["latency"], ref["latency"])
    loss_rel = max_rel(out["loss"], ref["loss"])
    k3_want, k3_how = hier_k3_expected(cfg, engine, out)
    kernels = ra_backend is None
    k1_want = 1 if ra_solver == "fused" and kernels else 0
    k2_want = hier_k2_expected(cfg) if ra_solver == "step" and kernels else 0
    line("  " + "; ".join(f"{f} == cpu: {v}" for f, v in same.items())
         + f"; latency max_rel vs cpu: {lat_rel:.3e} (limit 1e-6); loss max_rel vs cpu: "
         f"{loss_rel:.3e} (limit 1e-4); transmissions: {int(out['tx'].sum())}")
    line(f"  K1 launches={launches['polyblock_fused']} (expected {k1_want}); K2 launches="
         f"{launches['polyblock_project']} (expected {k2_want}); K3 launches="
         f"{launches['fedavg_agg']} (the traces imply {k3_want}: {k3_how})")
    for kernel in need:
        if launches[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the hierarchy path {name}")
    if (launches["polyblock_fused"], launches["polyblock_project"],
            launches["fedavg_agg"]) != (k1_want, k2_want, k3_want):
        raise AssertionError(f"hier {name}: K1/K2/K3 launches differ from the expected counts")
    if not (np.all(np.isfinite(out["loss"])) and out["loss"].shape == (cfg.rounds,)):
        raise AssertionError("hier: losses are not finite / not one per round")
    if not out["loss"][-1] < out["loss"][0]:
        raise AssertionError("hier: training did not lower the loss")
    if not np.array_equal(again["tx"], out["tx"]):
        raise AssertionError("hier: two runs of the same seed on the card differ in tx")
    if not all(same.values()):
        raise AssertionError(f"hier {name}: traces differ from the CPU run")
    if not (lat_rel <= 1e-6 and loss_rel <= 1e-4):
        raise AssertionError(f"hier {name}: latency or loss too far from the CPU run")
    return out, launches


# ---------------------------------------------------------------------------
# a run_many group as one batch on a cell axis
# ---------------------------------------------------------------------------

# `examples/torch_reproduce_figures.py`'s default widths (mnist MLP at Table-I
# width, N 20, K 4, 500 samples, eval every 5 rounds) at 5 rounds (the depth
# is cut to keep the whole script well inside its time limit: 10 until the
# training phase took the donated Adafactor's runs), the four paper
# DS policies x seeds 0-3: one 16-cell group per engine.
BATCH_SIM = dict(dataset="mnist", n_devices=20, n_subchannels=4, n_samples=500,
                 eval_every=5, rounds=5)
BATCH_SEEDS = (0, 1, 2, 3)


class RoundReads:
    """The host reads of every call of a round body (`owner.name`) while
    the context is open, one count per call: per round of a group or of a
    solo run."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self) -> list[int]:
        body = self.orig = getattr(self.owner, self.name)

        def counted(*args, **kw):
            before = host_int.syncs
            out = body(*args, **kw)
            self.calls.append(host_int.syncs - before)
            return out

        setattr(self.owner, self.name, counted)
        return self.calls

    def __exit__(self, *exc) -> None:
        setattr(self.owner, self.name, self.orig)


def batch_phase(aggregation: str) -> dict:
    """One 16-cell `run_many` group (`BATCH_SIM`, PAPER_BASELINE_DS x
    BATCH_SEEDS) on the scan engine (`aggregation="sync"`) or the async one,
    run once as a group on the card, then every cell alone on the card:
    every cell bitwise its solo run in every field (the async engine's
    commit and pending traces too); one cell per policy (seed 0, one CPU
    group) with its traces equal to the CPU's and its loss within 1e-4; K1
    once and K3 once per aggregation of the group (the traces imply how
    often); the group's host reads per round within Σ over its policies of
    the most reads any of that policy's cells makes alone, plus one (the
    who-trains read); the group's wall time beside the sum of the solo
    runs' and the serial reads beside the group's."""
    cfgs = [SimConfig(**BATCH_SIM, seed=s, policy=RoundPolicy(ds=d), aggregation=aggregation)
            for d in PAPER_BASELINE_DS for s in BATCH_SEEDS]
    owner, body = ((sim_mod, "sync_group_round") if aggregation == "sync"
                   else (async_loop, "group_event"))
    with RoundReads(owner, body) as group_reads:
        hists, wall, launches, syncs = run_on_card(cfgs, run_many, engine="scan")
    k3_cells = fedavg_aggregate_leaves_batched.launches
    solo_walls, solo_reads, differ = [], [], []
    for c, h in zip(cfgs, hists):
        with RoundReads(owner, body) as reads:
            alone, w, _, _ = run_on_card(c, engine="scan")
        solo_walls.append(w)
        solo_reads.append(list(reads))
        if bitwise_diff(h, alone, skip=()):
            differ.append(f"{c.policy.ds}/seed{c.seed}: {bitwise_diff(h, alone, skip=())}")
    rounds = cfgs[0].rounds
    bound = [1 + sum(max(solo_reads[i][r] - 1 for i, c in enumerate(cfgs)
                         if c.policy.ds == ds) for ds in PAPER_BASELINE_DS)
             for r in range(rounds)]
    k3_want = rounds if aggregation != "sync" else group_k3_expected(hists)
    name = "scan" if aggregation == "sync" else "async"
    line(f"main path batch engine={name} aggregation={aggregation}: {len(cfgs)} cells "
         f"({len(PAPER_BASELINE_DS)} policies x seeds {BATCH_SEEDS}) in one group, mnist "
         f"N={cfgs[0].n_devices} K={cfgs[0].n_subchannels} rounds={rounds}: group "
         f"wall_s={wall:.3f} against the sum of the {len(cfgs)} solo runs "
         f"{sum(solo_walls):.3f} (x{sum(solo_walls) / wall:.2f}); launches "
         + " ".join(f"{k}={v}" for k, v in launches.items()) + f" [{CARD}]")
    line(f"  host reads: group {syncs} ({syncs / rounds:.2f} per group round; the bound "
         f"Σ_policy max_cell + 1: {sum(bound)}, {sum(bound) / rounds:.2f} per round); the "
         f"cells one after another {sum(map(sum, solo_reads))} "
         f"({sum(map(sum, solo_reads)) / rounds:.2f} per round)")
    line(f"  K1 launches={launches['polyblock_fused']} (expected 1: one Γ solve for the "
         f"group); K3 launches={launches['fedavg_agg']} (the traces imply {k3_want}: "
         + ("one per event" if aggregation != "sync" else
            "one per round in which any cell trained")
         + f"), of which through the cell axis {k3_cells}")
    line(f"  {len(cfgs)} cells vs their solo runs on the card: bitwise equal in every field "
         f"(commit and async traces included): {not differ}"
         + (f" (differ: {differ})" if differ else ""))
    firsts = [i for i, c in enumerate(cfgs) if c.seed == BATCH_SEEDS[0]]
    t0 = time.perf_counter()
    refs = run_many([cfgs[i] for i in firsts], engine="scan", device="cpu")
    cpu_wall = time.perf_counter() - t0
    same = []
    for i, ref in zip(firsts, refs):
        h = hists[i]
        eq = {f: np.array_equal(getattr(h, f), getattr(ref, f))
              for f in ("tx_trace", "age_trace", "commit_trace") if getattr(ref, f) is not None}
        loss_rel = max_rel(h.global_loss, ref.global_loss)
        same.append(all(eq.values()) and loss_rel <= 1e-4)
        line(f"  {cfgs[i].policy.ds}/seed{cfgs[i].seed} vs the cpu group: "
             + "; ".join(f"{f} == cpu: {v}" for f, v in eq.items())
             + f"; loss max_rel vs cpu: {loss_rel:.3e} (limit 1e-4)")
    line(f"  cpu group of {len(firsts)} cells: wall_s={cpu_wall:.3f}")
    if differ:
        raise AssertionError(f"batch {name}: cells differ from their solo runs: {differ}")
    if not all(same):
        raise AssertionError(f"batch {name}: traces or losses differ from the CPU's")
    if (launches["polyblock_fused"], launches["fedavg_agg"]) != (1, k3_want) or k3_cells != k3_want:
        raise AssertionError(f"batch {name}: K1/K3 launches differ from the expected counts")
    if any(g > b for g, b in zip(group_reads, bound)) or len(group_reads) != rounds:
        raise AssertionError(f"batch {name}: host reads per round {group_reads} exceed the "
                             f"bound {bound}")
    for h in hists:
        if not (np.all(np.isfinite(h.global_loss)) and h.global_loss[-1] < h.global_loss[0]):
            raise AssertionError(f"batch {name}: a cell's loss is not finite or did not fall")
    return dict(launches=launches, wall_s=wall, solo_wall_s=sum(solo_walls), reads=syncs,
                bound=sum(bound), serial_reads=sum(map(sum, solo_reads)), cfgs=cfgs,
                hists=hists)


# Phase 8's hierarchy (2 cells x 10 devices x 4 sub-channels, 400 samples,
# mnist MLP at full width) at 10 rounds (phase 8 runs 30; the depth is cut to
# keep the whole script well inside its time limit: 15 until the training
# phase took the donated Adafactor's runs) x the four paper DS policies x
# seeds 0-1: one 8-config `run_hier_many` group per engine.
HIER_BATCH_SEEDS = (0, 1)
HIER_BATCH_ROUNDS = 10


def hier_batch_phase(aggregation: str) -> dict:
    """One 8-config `run_hier_many` group (`HierSimConfig(rounds=10)`,
    PAPER_BASELINE_DS x HIER_BATCH_SEEDS) on the scan engine
    (`aggregation="sync"`) or the two-tier async one (`aggregation` at both
    tiers), run once as a group on the card, then every config alone on the
    card: every config bitwise its solo run in every field; one config per
    policy (seed 0, one CPU group) with its traces equal to the CPU's and
    its loss within 1e-4; K1 once per distinct world; K3 exactly as the
    group rule and the traces imply (`hier_group_k3_expected`); the host
    reads of every (round, cell) of the group within the flat group's
    bound carried to that cell index: 1 (the who-trains read) + Σ over its
    policies of the most reads any of that policy's configs makes alone at
    that (round, cell), less its own who-trains read; the group's wall time
    beside the sum of the solo runs'."""
    cfgs = [HierSimConfig(rounds=HIER_BATCH_ROUNDS, seed=s, policy=RoundPolicy(ds=d),
                          aggregation=aggregation, global_aggregation=aggregation)
            for d in PAPER_BASELINE_DS for s in HIER_BATCH_SEEDS]
    engine = "scan" if aggregation == "sync" else "async"
    owner, body = ((hier, "sync_group_round") if aggregation == "sync"
                   else (hier_async, "group_event"))
    with RoundReads(owner, body) as group_reads:
        hists, wall, launches, syncs = run_on_card(cfgs, run_hier_many, engine="scan")
    solo_walls, solo_reads, differ = [], [], []
    for c, h in zip(cfgs, hists):
        with RoundReads(owner, body) as reads:
            alone, w, _, _ = run_on_card([c], run_hier_many, engine="scan")
        solo_walls.append(w)
        solo_reads.append(list(reads))
        if bitwise_diff(h, alone[0], skip=()):
            differ.append(f"{c.policy.ds}/seed{c.seed}: {bitwise_diff(h, alone[0], skip=())}")
    cfg = cfgs[0]
    rounds, n_cells = cfg.rounds, cfg.n_cells
    shape = (rounds, n_cells, cfg.devices_per_cell)
    calls = rounds * n_cells
    bound = [1 + sum(max(solo_reads[i][j] - 1 for i, c in enumerate(cfgs)
                         if c.policy.ds == ds) for ds in PAPER_BASELINE_DS)
             for j in range(calls)]
    per_round = [sum(group_reads[r * n_cells:(r + 1) * n_cells]) for r in range(rounds)]
    bound_round = [sum(bound[r * n_cells:(r + 1) * n_cells]) for r in range(rounds)]
    # The same bound read per round over whole solo rounds, for comparison:
    # Σ over policies of the most any config reads alone in the round, + C.
    solo_round = [[sum(rd[r * n_cells:(r + 1) * n_cells]) for r in range(rounds)]
                  for rd in solo_reads]
    whole = [n_cells + sum(max(solo_round[i][r] for i, c in enumerate(cfgs)
                               if c.policy.ds == ds) for ds in PAPER_BASELINE_DS)
             for r in range(rounds)]
    k3_want, k3_how = hier_group_k3_expected(cfg, engine, [h.tx_trace.reshape(shape)
                                                           for h in hists])
    k1_want = len(HIER_BATCH_SEEDS)
    serial = sum(map(sum, solo_reads))
    line(f"main path hier batch engine={engine} aggregation={aggregation}/{aggregation}: "
         f"{len(cfgs)} configs ({len(PAPER_BASELINE_DS)} policies x seeds {HIER_BATCH_SEEDS}) "
         f"in one group, {n_cells} cells x {cfg.devices_per_cell} devices x "
         f"{cfg.subchannels_per_cell} sub-channels, mnist rounds={rounds}: group "
         f"wall_s={wall:.3f} against the sum of the {len(cfgs)} solo runs "
         f"{sum(solo_walls):.3f} (x{sum(solo_walls) / wall:.2f}); launches "
         + " ".join(f"{k}={v}" for k, v in launches.items()) + f" [{CARD}]")
    line(f"  host reads: group {syncs} ({syncs / rounds:.2f} per group round; the bound, "
         f"per (round, cell) 1 + Σ_policy max_config (alone - 1): {sum(bound)}, "
         f"{sum(bound) / rounds:.2f} per round; equal at every (round, cell): "
         f"{group_reads == bound}); max per round {max(per_round)} against "
         f"Σ_policy max_config over whole solo rounds + C: {max(whole)} (held every "
         f"round: {all(g <= b for g, b in zip(per_round, whole))}); the configs one "
         f"after another {serial} ({serial / rounds:.2f} per round)")
    line(f"  K1 launches={launches['polyblock_fused']} (expected {k1_want}: one Γ solve per "
         f"distinct world); K3 launches={launches['fedavg_agg']} (the group rule and the "
         f"traces imply {k3_want}: {k3_how})")
    line(f"  {len(cfgs)} configs vs their solo runs on the card: bitwise equal in every "
         f"field (commit and async traces included): {not differ}"
         + (f" (differ: {differ})" if differ else ""))
    firsts = [i for i, c in enumerate(cfgs) if c.seed == HIER_BATCH_SEEDS[0]]
    t0 = time.perf_counter()
    refs = run_hier_many([cfgs[i] for i in firsts], engine="scan", device="cpu")
    cpu_wall = time.perf_counter() - t0
    same = []
    for i, ref in zip(firsts, refs):
        h = hists[i]
        eq = {f: np.array_equal(getattr(h, f), getattr(ref, f))
              for f in ("tx_trace", "age_trace", "commit_trace") if getattr(ref, f) is not None}
        if ref.async_trace is not None:
            eq["cell_committed"] = np.array_equal(h.async_trace["cell_committed"],
                                                  ref.async_trace["cell_committed"])
        loss_rel = max_rel(h.global_loss, ref.global_loss)
        same.append(all(eq.values()) and loss_rel <= 1e-4)
        line(f"  {cfgs[i].policy.ds}/seed{cfgs[i].seed} vs the cpu group: "
             + "; ".join(f"{f} == cpu: {v}" for f, v in eq.items())
             + f"; loss max_rel vs cpu: {loss_rel:.3e} (limit 1e-4)")
    line(f"  cpu group of {len(firsts)} configs: wall_s={cpu_wall:.3f}")
    if differ:
        raise AssertionError(f"hier batch {engine}: configs differ from their solo runs: "
                             f"{differ}")
    if not all(same):
        raise AssertionError(f"hier batch {engine}: traces or losses differ from the CPU's")
    if (launches["polyblock_fused"], launches["fedavg_agg"]) != (k1_want, k3_want):
        raise AssertionError(f"hier batch {engine}: K1/K3 launches differ from the expected "
                             f"counts")
    if len(group_reads) != calls or any(g > b for g, b in zip(group_reads, bound)):
        raise AssertionError(f"hier batch {engine}: host reads per (round, cell) "
                             f"{group_reads} exceed the bound {bound}")
    for h in hists:
        if not (np.all(np.isfinite(h.global_loss)) and h.global_loss[-1] < h.global_loss[0]):
            raise AssertionError(f"hier batch {engine}: a config's loss is not finite or did "
                                 f"not fall")
    return dict(launches=launches, wall_s=wall, solo_wall_s=sum(solo_walls), reads=syncs,
                bound=sum(bound), serial_reads=serial, cfgs=cfgs, hists=hists)


# ---------------------------------------------------------------------------
# the sweep harness and the sustained service
# ---------------------------------------------------------------------------

# The paper's four DS baselines at `examples/torch_reproduce_figures.py`'s
# default widths (mnist, N 20, K 4, 500 samples, eval every 5 rounds), crossed
# with aggregation sync / async and cell counts 1 / 2, at 10 rounds (the depth
# is cut to keep the whole script well inside its time limit).
SWEEP_SPEC = dict(name="fig3_convergence", datasets="mnist", ds=PAPER_BASELINE_DS,
                  aggregation=("sync", "async"), cell_counts=(1, 2), seeds=(0, 1),
                  rounds=10, n_devices=20, n_subchannels=4, target_loss=1.0,
                  overrides={"n_samples": 500, "eval_every": 5})
# `python -m repro_torch.service.run --ra mo` at its defaults.
SERVICE_SIM = dict(dataset="mnist", n_devices=64, n_subchannels=16, n_samples=128,
                   batch=16, local_steps=1, scenario="churn", aggregation="async",
                   policy=RoundPolicy(ra="mo"))
SERVICE_SEGMENTS = 2
# Events of a segment of the fresh services that hold the service to itself
# and to the CPU (two chained halves against one whole, the CPU's, the
# step driver's) and of the open loop's: 100 and 50 until the training
# phase took the donated Adafactor's runs.
SERVICE_CHECK_EVENTS = 50
# Events of the profiled service segment: the profiler reads its trace back
# at ~0.7 ms a kernel, and an event launches ~1 900 (a 100-event segment,
# ~185 000 kernels, took over two minutes to read back).
SERVICE_PROFILE_EVENTS = 10


def k1_bound(label: str, beta64, h264, e64, cfg) -> dict:
    """K1 at one path's pairs (float64): its output against the plain
    float64 version on the same pairs, under phase 4's contract (`check_k1`:
    > 97% of pairs on the plain version's trajectory, within 1e-9 relative
    there, |dT| <= eps on the rest); its bound: the operations this data
    needs (`k1_ops`, from the solve's own iteration counts) at the card's
    peak rate, against the bytes at its memory rate; the longest pair's
    chain (`chain_calls`) at the latency per evaluation the one-lane
    schedule's time implies; and the time of the schedule the lanes rule
    picks."""
    args = (beta64, h264, e64)
    lanes = coop_lanes(beta64.shape[0])
    got = polyblock_solve_fused(*args, cfg)
    want = polyblock_solve_plain(*args, cfg)
    torch.cuda.synchronize()
    share, errs, dt, n_rest = trajectory(got, want)
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    iters = got[3]
    ms = time_ms(lambda: polyblock_solve_fused(*args, cfg), 10, prefill=True)
    ms1 = time_ms(lambda: polyblock_solve_fused(*args, cfg, lanes=1), 10, prefill=True)
    per_call_ns = ms1 / chain_calls(*args, iters, cfg, 1) * 1e6
    crit_ms = chain_calls(*args, iters, cfg, lanes) * per_call_ns * 1e-6
    b_ms, b_by = bound_ms(k1_ops(*args, iters, cfg), beta64.shape[0] * (6 * 8 + 4),
                          torch.float64)
    line(f"K1 bound at {label}: pairs={beta64.shape[0]} max_iters={int(iters.max())} "
         f"lanes={lanes} kernel_ms={ms:.4f} (lanes=1 {ms1:.4f}) bound_ms={b_ms:.5f} "
         f"({b_by}) critical_path_ms={crit_ms:.4f} [{CARD}]")
    line(f"  vs plain float64: {fmt(share, errs, dt, n_rest)} (limits: > 0.97, 1e-9, eps); "
         f"max_abs_err(tau,p,T)={max_abs:.3e}")
    if not (share > 0.97 and max(errs) < 1e-9 and dt <= EPS + 1e-6):
        raise AssertionError(f"K1 at {label}: kernel disagrees with plain")
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, critical_path_ms=crit_ms, lanes=lanes,
                max_abs_err=max_abs)


def hier_pairs(cfg: HierSimConfig):
    """The pairs the hierarchy's one Γ solve hands K1: every cell's
    (rounds, K, N) horizon, Prop-1 filtered."""
    prep = hier._prepare_hier(cfg, torch.device("cpu"))
    return (*feasible_pairs(prep.beta[:, None, None, :], prep.h2_all,
                            prep.emax_all[:, :, None, :], prep.wcfg), prep.wcfg)


def sweep_k1_expected(spec: SweepSpec) -> int:
    """K1 launches of one `run_sweep` of `spec`, from its axes: the sweep
    hands all flat cells to one `run_many` call and all multi-cell ones to
    one `run_hier_many` call.  `run_many` concatenates every MO world that
    shares one wireless setting into one solver call, and the spec has one
    (a single dataset, N, K and scenario); `run_hier_many` solves each
    multi-cell world once, one per (seed, cell count) here.  Each call
    launches K1 once, since every world of this size has a feasible pair."""
    axes = (spec.datasets, spec.n_devices, spec.n_subchannels, spec.scenarios,
            spec.global_aggregation)
    if (any(len(a) != 1 for a in axes)
            or {k for k, _ in spec.overrides} - {"n_samples", "eval_every"}):
        raise AssertionError("sweep_k1_expected counts a spec of one wireless setting")
    if "mo" not in spec.ra:
        return 0
    flat = 1 in spec.cell_counts
    worlds = len(spec.seeds) * len([c for c in spec.cell_counts if c > 1])
    return int(flat) + worlds


def sweep_k3_expected(cells, hists) -> int:
    """K3 launches of one `run_sweep`, from its traces.  Every aggregation
    is one launch.  The flat cells go to one `run_many` call, which runs
    the cells that share a model (`sim._scan_group_key`) as one group on
    each engine, and a group aggregates all its cells in one launch: once
    per round in which any of its cells trained (scan), once per event
    (async).  The hierarchical cells go to one `run_hier_many` call, which
    groups them alike (`hier._hier_group_key`), each group counted by
    `hier_group_k3_expected`."""
    total, groups, hier_groups = 0, {}, {}
    for c, hist in zip(cells, hists):
        cfg = c.config
        is_async = hist.commit_trace is not None
        if isinstance(cfg, HierSimConfig):
            hier_groups.setdefault((is_async, hier._hier_group_key(cfg)), []).append(
                (cfg, hist.tx_trace.reshape(cfg.rounds, cfg.n_cells, cfg.devices_per_cell)))
        else:
            groups.setdefault((is_async, sim_mod._scan_group_key(cfg)), []).append(hist)
    for (is_async, _), hs in groups.items():
        total += (hs[0].tx_trace.shape[0] if is_async
                  else group_k3_expected(hs))
    for (is_async, _), members in hier_groups.items():
        total += hier_group_k3_expected(members[0][0], "async" if is_async else "scan",
                                        [tx for _, tx in members])[0]
    return total


def group_k3_expected(hists) -> int:
    """K3 launches of one scan group: one per round in which any of its
    cells trained."""
    return int(np.any([h.tx_trace.any(axis=1) for h in hists], axis=0).sum())


def solo(cfg, device):
    """One sweep cell's config through the solo entry point."""
    if isinstance(cfg, HierSimConfig):
        return run_hier_many([cfg], engine="scan", device=device)[0]
    return run_simulation(cfg, engine="scan", device=device)


def sweep_phase() -> dict:
    """The sweep of `SWEEP_SPEC` through `run_sweep(engine="scan")` on the
    card, writing its record and gallery into a temporary directory: K1
    and K3 launched as often as the code implies (`sweep_k1_expected`,
    `sweep_k3_expected`); one cell per (aggregation, cell count) bitwise
    equal to its solo run on the card, and its tx and AoU traces equal to
    the same solo run on the CPU."""
    spec = SweepSpec(**SWEEP_SPEC)
    laps = Laps()
    with tempfile.TemporaryDirectory() as tmp:
        res, wall, launches, syncs = run_on_card(spec, run_sweep, engine="scan",
                                                 results_root=tmp, figures=True)
        svgs = sorted(p.name for p in (res.out_dir / "figures").glob("*.svg"))
    laps.lap("run_sweep")
    cells, hists = res.cells, res.histories
    k1_want = sweep_k1_expected(spec)
    k3_want = sweep_k3_expected(cells, hists)
    rounds = sum(c.config.rounds for c in cells)
    line(f"main path sweep {spec.name}: {len(cells)} cells ({len(spec.policies)} policies x "
         f"aggregation {spec.aggregation} x cell_counts {spec.cell_counts} x seeds "
         f"{spec.seeds}), mnist N={spec.n_devices[0]} K={spec.n_subchannels[0]} "
         f"rounds={spec.rounds}, engine=scan: wall_s={res.record['wall_s']:.3f} (call "
         f"{wall:.3f}, incl. record and gallery); launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; host reads={syncs} ({syncs / rounds:.2f} per cell round); env "
         f"{res.record['env']} [{CARD}]")
    line(f"  K1 launches={launches['polyblock_fused']} (expected {k1_want}: one per "
         f"solver call); K3 launches={launches['fedavg_agg']} (the traces imply {k3_want}); "
         f"gallery: {len(svgs)} SVG files ({', '.join(svgs[:4])}, ...)")
    for c in res.record["cells"][:: len(spec.seeds) * len(spec.policies)]:
        m = c["metrics"]
        line(f"  {c['id']}: final_loss={m['final_loss']:.4f} rounds_to_target="
             f"{m['rounds_to_target']} time_to_target_s={m['time_to_target_s']} "
             f"utilization={m['mean_subchannel_utilization']:.4f} cumulative_latency_s="
             f"{m['cumulative_latency_s']:.3f}")
    if (launches["polyblock_fused"], launches["fedavg_agg"]) != (k1_want, k3_want):
        raise AssertionError("sweep: K1/K3 launches differ from the expected counts")
    if launches["polyblock_project"]:
        raise AssertionError("sweep: K2 launched on the fused path")
    if len(svgs) < 4 * 4:
        raise AssertionError(f"sweep: the gallery holds {len(svgs)} figures")
    for h in hists:
        if not (np.all(np.isfinite(h.global_loss)) and h.tx_trace.any()):
            raise AssertionError("sweep: a cell's losses are not finite or nothing trained")
    by_group: dict = {}
    for c, h in zip(cells, hists):
        by_group.setdefault((c.config.aggregation, getattr(c.config, "n_cells", 1)),
                            []).append((c, h))
    for (agg, n_cells), members in by_group.items():
        cell, hist = members[0]
        mean0 = np.mean([h.global_loss[0] for _, h in members])
        mean1 = np.mean([h.global_loss[-1] for _, h in members])
        if not mean1 < mean0:
            raise AssertionError(f"sweep {agg} C={n_cells}: training did not lower the loss")
        assert_bitwise(hist, solo(cell.config, DEV),
                       f"sweep cell {cell.cell_id} vs its solo run on the card")
        laps.lap(f"solo card {agg} C={n_cells}")
        ref = solo(cell.config, "cpu")
        laps.lap(f"solo cpu {agg} C={n_cells}")
        same = {f: np.array_equal(getattr(hist, f), getattr(ref, f))
                for f in ("tx_trace", "age_trace", "commit_trace")
                if getattr(ref, f) is not None}
        line(f"  {cell.cell_id} vs the cpu: " + "; ".join(f"{f} == cpu: {v}"
                                                         for f, v in same.items())
             + f"; loss max_rel vs cpu: {max_rel(hist.global_loss, ref.global_loss):.3e}")
        if not all(same.values()):
            raise AssertionError(f"sweep cell {cell.cell_id}: traces differ from the CPU run")
    laps.print("sweep phase")
    return dict(launches=launches, wall_s=res.record["wall_s"])


def service_config(**kw) -> ServiceConfig:
    return ServiceConfig(sim=SimConfig(**SERVICE_SIM), **kw)


def service_k1_expected(cfg: ServiceConfig, segments: int) -> int:
    """K1 launches of `segments` segments: one per segment with a feasible
    pair, replayed from a fresh stream of the same seed."""
    sim = cfg.sim
    stream = ScenarioStream(sim.seed, sim.wireless(), sim.scenario)
    n = 0
    for _ in range(segments):
        tr = stream.next_segment(cfg.segment_events)
        e_max = np.broadcast_to(tr.e_max_j[:, None, :], tr.h2_all.shape)
        n += bool((~is_infeasible(tr.h2_all, sim.wireless(), e_max)).any())
    return n


def service_phase() -> dict:
    """The sustained service at `service/run.py`'s defaults with `--ra mo`:
    one warm-up and `SERVICE_SEGMENTS` measured segments of 100 events,
    closed loop, with K1 once per segment and K3 once per event; the third
    segment of a service of `SERVICE_PROFILE_EVENTS`-event segments under
    the profiler; then, on fresh services, 2 chained segments of
    SERVICE_CHECK_EVENTS / 2 events bitwise equal to one of
    SERVICE_CHECK_EVENTS, that segment against the same segment on the CPU
    (dispatches, commits, AoU and the buffer exact, latency within 1e-6,
    loss within 1e-4), one segment with ra_solver="step" (K2) whose
    dispatches equal the fused segment's, and one open-loop segment of
    SERVICE_CHECK_EVENTS / 2 events at half the measured closed-loop
    rate."""
    cfg = service_config()
    sim = cfg.sim
    laps = Laps()
    svc = SustainedService(cfg, device=DEV)
    rec, wall, launches, syncs = run_on_card(SERVICE_SEGMENTS,
                                             lambda n, device: svc.serve(n))
    events = svc.events_served
    s = rec["summary"]
    laps.lap(f"serve (warm-up + {SERVICE_SEGMENTS} segments)")
    k1_want = service_k1_expected(cfg, cfg.warmup_segments + SERVICE_SEGMENTS)
    laps.lap("K1 count replay")
    line(f"main path service: mnist N={sim.n_devices} K={sim.n_subchannels} "
         f"samples={sim.n_samples} batch={sim.batch} scenario={sim.scenario} ra=mo, "
         f"{cfg.warmup_segments} warm-up + {SERVICE_SEGMENTS} segments of "
         f"{cfg.segment_events} events, closed loop: events/s="
         f"{s['throughput_events_per_s']:.3f} p50={s['latency_s']['p50']:.4f}s "
         f"p95={s['latency_s']['p95']:.4f}s p99={s['latency_s']['p99']:.4f}s SLO "
         f"attained={s['slo']['attained']:.3f} at {s['slo']['budget_s']:g}s; warm-up "
         f"segment {rec['walls']['warmup_s'][0]:.3f}s, segments "
         + " ".join(f"{w:.3f}" for w in rec["walls"]["segment_s"])
         + f"s; call wall_s={wall:.3f} [{CARD}]")
    line(f"  launches " + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; K1 launches={launches['polyblock_fused']} (expected {k1_want}: one per "
         f"segment with a feasible pair); K3 launches={launches['fedavg_agg']} (expected "
         f"{events}: one per event); host reads={syncs} ({syncs / events:.2f} per event); "
         f"mean pending {s['buffer']['mean_pending']:.3f}; steady-state loss "
         + " ".join(f"{x:.4f}" for x in rec["steady_state"]["global_loss"]))
    if (launches["polyblock_fused"], launches["fedavg_agg"]) != (k1_want, events):
        raise AssertionError("service: K1/K3 launches differ from the expected counts")
    losses = np.asarray(rec["steady_state"]["global_loss"])
    if not (np.all(np.isfinite(losses)) and losses.shape == (SERVICE_SEGMENTS,)):
        raise AssertionError("service: steady-state losses are not finite / one per segment")
    if not losses[-1] < losses[0]:
        raise AssertionError("service: training did not lower the loss")
    # The profiled window: a segment of SERVICE_PROFILE_EVENTS events, the
    # third of its own service (the first two warm it up).
    short = SustainedService(service_config(segment_events=SERVICE_PROFILE_EVENTS,
                                            eval_every_events=SERVICE_PROFILE_EVENTS), device=DEV)
    for _ in range(2):
        short.run_segment()
    k1_before = polyblock_solve_fused.launches
    prof = profile_call(f"service segment ({SERVICE_PROFILE_EVENTS} events, the third of "
                        f"its service)", short.run_segment, focus=("solve_", "agg_leaves"))
    line(f"  K1 launches in the profiled segment: {polyblock_solve_fused.launches - k1_before}")
    k1_ms = "not measured" if prof["solve_"] is None else f"{prof['solve_']:.4f}"
    idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.4f}"
    line(f"  K1 device ms per segment (profiler)={k1_ms}; idle share of the segment={idle} "
         f"[{CARD}]")
    laps.lap("profiled segment")

    n, half = SERVICE_CHECK_EVENTS, SERVICE_CHECK_EVENTS // 2
    check_cfg = service_config(segment_events=n, eval_every_events=half)
    halves = SustainedService(service_config(segment_events=half, eval_every_events=half),
                              device=DEV)
    whole = SustainedService(check_cfg, device=DEV)
    parts = [halves.run_segment() for _ in range(2)]
    one = whole.run_segment()
    diff = [k for k in one if not np.array_equal(np.concatenate([p[k] for p in parts]),
                                                 one[k])]
    line(f"service on the card: 2 chained segments of {half} events vs one of {n}, bitwise "
         f"equal on every key ({len(one)}): {not diff}" + (f" (differ: {diff})" if diff else ""))
    if diff:
        raise AssertionError(f"service: chained segments differ on {diff}")
    laps.lap(f"2 x {half} vs {n} events")

    t0 = time.perf_counter()
    ref = SustainedService(check_cfg, device="cpu").run_segment()
    cpu_wall = time.perf_counter() - t0
    same = {k: bool(np.array_equal(one[k], ref[k]))
            for k in ("transmitted", "committed", "age", "n_pending", "selected", "overflow")}
    lat_rel = max_rel(one["latency"], ref["latency"])
    loss_rel = max_rel(one["loss"], ref["loss"])
    line(f"service segment of {n} events, card vs cpu: " + "; ".join(
        f"{k} == cpu: {v}" for k, v in same.items())
        + f"; latency max_rel vs cpu: {lat_rel:.3e} (limit 1e-6); loss max_rel vs cpu: "
        f"{loss_rel:.3e} (limit 1e-4); transmissions: {int(one['transmitted'].sum())}; "
        f"cpu wall_s={cpu_wall:.3f}")
    if not all(same.values()):
        raise AssertionError("service: the card's segment differs from the CPU's")
    if not (lat_rel <= 1e-6 and loss_rel <= 1e-4 and one["transmitted"].any()):
        raise AssertionError("service: latency or loss too far from the CPU's segment")
    laps.lap("cpu segment")

    step = SustainedService(check_cfg, ra_solver="step", device=DEV)
    ys, step_wall, step_launches, _ = run_on_card(None, lambda _, device: step.run_segment())
    same_tx = bool(np.array_equal(ys["transmitted"], one["transmitted"]))
    line(f"service segment ra_solver=step: launches "
         + " ".join(f"{k}={v}" for k, v in step_launches.items())
         + f"; wall_s={step_wall:.3f}; dispatches equal to the fused segment's: {same_tx} "
         f"[{CARD}]")
    if step_launches["polyblock_project"] < 1 or step_launches["polyblock_fused"]:
        raise AssertionError("service: the step segment did not run on K2 alone")
    if not same_tx:
        raise AssertionError("service: the step segment's dispatches differ from the fused")
    laps.lap("step segment")

    rate = 0.5 * s["throughput_events_per_s"]
    open_loop = SustainedService(service_config(target_rate_events_per_s=rate,
                                                warmup_segments=0, segment_events=half,
                                                eval_every_events=half), device=DEV)
    o = open_loop.serve(1)["summary"]
    line(f"service open loop at {rate:.3f} events/s (half the closed loop's), 1 segment "
         f"of {half} events: "
         f"events/s={o['throughput_events_per_s']:.3f} p50={o['latency_s']['p50']:.4f}s "
         f"p99={o['latency_s']['p99']:.4f}s SLO attained={o['slo']['attained']:.3f} "
         f"[{CARD}]")
    if not 0 < o["throughput_events_per_s"] <= rate:
        raise AssertionError("service: the open loop served faster than its arrivals")
    laps.lap("open loop")
    pairs = service_pairs(cfg)
    laps.lap("K1 pairs")
    laps.print("service phase")
    return dict(launches=launches, step_launches=step_launches, k1_ms=prof["solve_"],
                idle=prof["idle"], pairs=pairs)


def service_pairs(cfg: ServiceConfig):
    """The pairs of the service's first segment that K1 is handed."""
    sim = cfg.sim
    beta = sim_mod._sample_dataset(sim, np.random.default_rng(sim.seed),
                                   torch.device("cpu"))[2]
    tr = ScenarioStream(sim.seed, sim.wireless(), sim.scenario).next_segment(
        cfg.segment_events)
    return (*feasible_pairs(beta[None, None, :], tr.h2_all, tr.e_max_j[:, None, :],
                            sim.wireless()), sim.wireless())


# ---------------------------------------------------------------------------
# the Γ solver's projection backends
# ---------------------------------------------------------------------------

RA_BACKENDS = ("newton", "mixed", "bisect")
# Relative limits ((tau, p), (time, energy)) of a plain backend's Γ on the
# card, at both pair sets: against the same backend on the CPU, and against K1.
# "bisect" and "mixed" converge: against the CPU, the limits the CPU tests
# hold the port to against the JAX package (tests/test_torch_ra_backends.py:
# two libraries' log1p and exp, as here CUDA's and the CPU's); against K1 (a
# bisection), K2's float64 limit against its plain version for "bisect" and
# the JAX package's own agreement of "mixed" with its bisection (T 1e-8,
# tau 5e-8).  A 14-step "newton" root that has not converged moves with the
# last bit of log1p and exp: the JAX package's own "newton" sits 2.05e-8
# from its bisection at the service's pairs (tau, p and T; the CPU test
# `test_backend_gaps_at_the_service_pairs`), hence 5e-8 for it everywhere.
RA_LIMITS = {"bisect": ((1e-11, 1e-11), (1e-10, 1e-10)),
             "newton": ((5e-8, 5e-8), (5e-8, 5e-8)),
             "mixed": ((2e-11, 5e-12), (5e-8, 1e-8))}
RA_FIELDS = (("tau", "p"), ("time_s", "energy_j"))


def gamma_gaps(got, want) -> tuple[float, float]:
    """Largest relative gaps of two RAResults on the feasible pairs: over
    tau and p, and over time and energy."""
    f = want.feasible
    return tuple(max(max_rel(getattr(got, k)[f], getattr(want, k)[f]) for k in ks)
                 for ks in RA_FIELDS)


def timed_solve(solve, pairs, **kw):
    """`solve` of one pair set on the card: its RAResult (the first call)
    and the wall ms of a second, warm call (the driver hands numpy back,
    so it ends synchronised)."""
    b, h, e, cfg = pairs
    res = solve(b, h, cfg, e, device=DEV, **kw)
    t0 = time.perf_counter()
    solve(b, h, cfg, e, device=DEV, **kw)
    return res, (time.perf_counter() - t0) * 1e3


def ra_gamma(label: str, pairs) -> dict:
    """Γ of one pair set by the step driver with each plain backend on the
    card, against the same on the CPU (iterations equal, values within
    RA_LIMITS) and against K1 on the card (iterations equal, values within
    RA_LIMITS); K1 and K2 launched by none of them.  Returns the wall ms
    of K1, K2 through the step driver and each plain backend."""
    b, h, e, cfg = pairs
    ms, failed = {}, []
    k1_res, ms["K1"] = timed_solve(solve_pairs_fused, pairs)
    _, ms["K2 step"] = timed_solve(solve_pairs_step, pairs)
    for backend in RA_BACKENDS:
        for fn in COUNTERS.values():
            fn.launches = 0
        got, ms[backend] = timed_solve(solve_pairs_step, pairs, backend=backend)
        k12 = (polyblock_solve_fused.launches, polyblock_project.launches)
        t0 = time.perf_counter()
        cpu = solve_pairs_step(b, h, cfg, e, backend=backend, device="cpu")
        cpu_s = time.perf_counter() - t0
        lim_cpu, lim_k1 = RA_LIMITS[backend]
        gap_cpu, gap_k1 = gamma_gaps(got, cpu), gamma_gaps(got, k1_res)
        it_cpu = np.array_equal(got.iterations, cpu.iterations)
        it_k1 = np.array_equal(got.iterations, k1_res.iterations)
        line(f"Γ {label} pairs={int(got.feasible.sum())} backend={backend} on the card: "
             f"iterations == cpu: {it_cpu}, == K1: {it_k1}; vs cpu (tau,p)={gap_cpu[0]:.3e} "
             f"(T,E)={gap_cpu[1]:.3e} (limits {lim_cpu[0]:g}, {lim_cpu[1]:g}); vs K1 "
             f"(tau,p)={gap_k1[0]:.3e} (T,E)={gap_k1[1]:.3e} (limits {lim_k1[0]:g}, "
             f"{lim_k1[1]:g}); K1 launches={k12[0]} K2 launches={k12[1]} (expected 0, 0); "
             f"max iterations={int(got.iterations.max())}; cpu solve_s={cpu_s:.2f}")
        if not (it_cpu and it_k1):
            failed.append(f"{backend}: iterations differ")
        if not all(g <= lim for g, lim in zip(gap_cpu + gap_k1, lim_cpu + lim_k1)):
            failed.append(f"{backend}: values beyond their limits")
        if k12 != (0, 0):
            failed.append(f"{backend}: K1 or K2 launched")
    line(f"Γ wall ms at {label} ({int(k1_res.feasible.sum())} pairs, warm call): "
         + " ".join(f"{k}={v:.2f}" for k, v in ms.items()) + f" [{CARD}]")
    if failed:
        raise AssertionError(f"Γ {label}: " + "; ".join(failed))
    return ms


def ra_backend_phase(main_cfg: SimConfig, step_cfg: SimConfig, hier_cfg: HierSimConfig,
                     pairs: dict) -> dict:
    """Phase 10b: Γ by each plain projection backend at `pairs` (label ->
    (beta, h2, e_max, cfg)), then the main paths with `ra_backend` set: the
    scan engine with "mixed", the step solver with "newton" (loop engine)
    and the hierarchy's scan engine with "mixed"; each against the same
    run on the CPU (`drive`, `drive_hier`), K1 and K2 launched 0 times, K3
    once per aggregation.  Returns the Γ wall ms by pair set and each run's
    launch counts."""
    ms = {label: ra_gamma(label, p) for label, p in pairs.items()}
    runs = {}
    for name, cfg, kw in (("mixed scan", main_cfg, dict(ra_backend="mixed", engine="scan")),
                          ("newton step", step_cfg, dict(ra_backend="newton",
                                                         ra_solver="step"))):
        hist, launches = drive(cfg, ("fedavg_agg",), **kw)
        aggregations = int(hist.tx_trace.any(1).sum())
        line(f"  ra_backend run {name}: K1 launches={launches['polyblock_fused']} K2 "
             f"launches={launches['polyblock_project']} (expected 0, 0); K3 launches="
             f"{launches['fedavg_agg']} (aggregations {aggregations}) [{CARD}]")
        if (launches["polyblock_fused"], launches["polyblock_project"],
                launches["fedavg_agg"]) != (0, 0, aggregations):
            raise AssertionError(f"ra_backend run {name}: launches differ from (0, 0, "
                                 f"{aggregations})")
        runs[name] = launches
    _, runs["hier mixed scan"] = drive_hier(hier_cfg, "scan", ("fedavg_agg",),
                                            ra_backend="mixed")
    return dict(ms=ms, launches=runs)


# ---------------------------------------------------------------------------
# the serving paths (model zoo)
# ---------------------------------------------------------------------------

SERVE = dict(batch=4, prompt_len=512, new_tokens=32, seed=0)
# Decode tokens of a profiled serving run: each profile is read back at
# ~0.7-1.8 ms a kernel on a slow host, so 4 (~2 500 kernels a qwen2-7b
# step) keep the script under its cap.
PROFILE_TOKENS = 4


class RoutingRecorder:
    """Inside `with`, every MoE layer's routing (`models.moe._dispatch`):
    per call, the (T, k) expert ids and a (T, E) code per token and expert:
    0 not chosen, 1 chosen and kept, 2 chosen and dropped by capacity.  (A
    set per token, not the top-k's order of probability, which a near-tie
    inside the k can swap without changing what the layer computes.)  With
    `replay` (a list of (T, k) expert ids, one per layer, in call order),
    each layer routes to the given experts instead of its own top k, their
    weights renormalised from its own probabilities."""

    def __init__(self, replay: list | None = None):
        self.replay = list(replay) if replay is not None else None

    def __enter__(self) -> list:
        self.calls, self.real_dispatch, self.real_route = [], moe_mod._dispatch, moe_mod._route

        def recording(top_e, n_local, capacity, e_offset=None):
            order, keep, slot = self.real_dispatch(top_e, n_local, capacity, e_offset)
            kept = torch.empty_like(keep)
            kept[order] = keep
            code = torch.zeros(top_e.shape[0], n_local, dtype=torch.int8, device=top_e.device)
            code.scatter_(1, top_e, (2 - kept.reshape(top_e.shape).to(torch.int8)))
            self.calls.append((top_e.clone(), code))
            return order, keep, slot

        def replaying(x2d, router_w, k):
            probs, _, _ = self.real_route(x2d, router_w, k)
            top_e = self.replay.pop(0)
            top_p = torch.gather(probs, 1, top_e)
            return probs, top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_e

        moe_mod._dispatch = recording
        if self.replay is not None:
            moe_mod._route = replaying
        return self.calls

    def __exit__(self, *exc) -> None:
        moe_mod._dispatch, moe_mod._route = self.real_dispatch, self.real_route


# Routing agreement of an MoE arch's two prefill paths: the first MoE layer
# sees one attention's difference (the kernel's bf16 output against "ref",
# which rounds the probabilities to bf16 before P.V); deeper layers compound
# it.  The floor of that noise is read in the same run from a witness that
# holds no kernel: plain K4 (`flash_attention_plain`) against "ref".  The
# kernel path must share at least ROUTE_FIRST of the choices at the first
# MoE layer, and at every layer at least the witness's minimum less
# ROUTE_MARGIN; the witness itself must reach ROUTE_FLOOR at every layer.
# (On the CPU, granite-moe-3b-a800m at full width, B 2 x S 512, the share
# settled at ~0.98 after ~10 layers, min 0.976 over 32, both for plain K4
# against "ref" and for the bf16 kernel's arithmetic against plain K4; on
# the card the kernel path's per-layer shares spread over 0.972-0.989, so
# the margin is that spread.)
ROUTE_FIRST, ROUTE_MARGIN, ROUTE_FLOOR = 0.99, 0.02, 0.95


def route_shares(got_routes, want_routes, b, s, k):
    """Per layer, the share of (token, slot) choices, expert and kept, that
    two recorded routings share, and the (b * s,) mask of the tokens routed
    alike at every layer."""
    rows_agree = torch.ones(b * s, dtype=torch.bool, device=DEV)
    shares = []
    for (_, gc_), (_, wc) in zip(got_routes, want_routes, strict=True):
        both = ((gc_ == wc) & (gc_ > 0)).sum(-1)
        shares.append(float(both.sum()) / (b * s * k))
        rows_agree &= both == k
    return shares, rows_agree


def moe_logits_check(arch, cfg, ref_cfg, params, batch) -> tuple[float, float]:
    """Prefill logits of an MoE arch, kernel path against "ref": routing is
    discontinuous (an ulp of attention can move a token to another
    expert, and a moved copy can shift which copies fit their capacity), so
    (1) per layer, the share of (token, slot) choices that the two paths
    share, held as the comment above says against the plain-K4 witness;
    (2) the logits within 4e-2 of the scale on the rows routed alike at
    every layer; (3) the whole tensor's error beside it; (4) the whole
    tensor within 4e-2 against "ref" routed as the kernel path routed
    (`RoutingRecorder(replay=...)`).  For a Mamba hybrid, (2) holds the
    tokens whose whole prefix was routed alike (the scan carries an earlier
    token routed elsewhere into every later state), and the rows routed
    alike are printed beside the witness's, ungated.  Returns (rows' error,
    replayed whole error)."""
    with RoutingRecorder() as got_routes:
        got = forward(cfg, params, batch)[0]
    with RoutingRecorder() as want_routes:
        want = forward(ref_cfg, params, batch)[0]
    with RoutingRecorder(replay=[e for e, _ in got_routes]):
        replayed = forward(ref_cfg, params, batch)[0]
    real_k4 = attention_mod.flash_attention
    attention_mod.flash_attention = flash_attention_plain
    try:
        with RoutingRecorder() as plain_routes:
            plain = forward(cfg, params, batch)[0]
    finally:
        attention_mod.flash_attention = real_k4
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(got_routes) == len(want_routes) == len(plain_routes) == n_moe
    b, s = batch["tokens"].shape
    shares, rows_agree = route_shares(got_routes, want_routes, b, s, cfg.top_k)
    witness, plain_agree = route_shares(plain_routes, want_routes, b, s, cfg.top_k)
    route_any = min(witness) - ROUTE_MARGIN
    g, w = got.float().reshape(b * s, -1), want.float().reshape(b * s, -1)
    r, pl = replayed.float().reshape(b * s, -1), plain.float().reshape(b * s, -1)
    del got, want, replayed, plain
    finite = all(bool(torch.isfinite(t).all()) for t in (g, w, r, pl))
    scale = float(w.abs().max())
    whole = float((g - w).abs().max()) / scale

    def err_on(x, mask):
        return float((x[mask] - w[mask]).abs().max()) / scale if bool(mask.any()) else float("nan")

    def prefix_of(mask):
        return torch.cummin(mask.reshape(b, s).int(), dim=1).values.bool().reshape(-1)

    rows, plain_rows = err_on(g, rows_agree), err_on(pl, plain_agree)
    same_routes = float((g - r).abs().max()) / float(r.abs().max())
    # A Mamba scan carries every earlier token of its sequence into a
    # token's state, so for a hybrid a token counts as routed alike only
    # when its whole prefix was (at every layer).
    scan = any(k.mixer == "mamba" for st in tf_mod.stage_plan(cfg) for k in st.pattern)
    prefix, plain_prefix = prefix_of(rows_agree), prefix_of(plain_agree)
    prefix_err, plain_prefix_err = err_on(g, prefix), err_on(pl, plain_prefix)
    for name, sh in (("plain K4 (witness)", witness), ("kernel path", shares)):
        line(f"  routing agreement per layer, {name} vs ref (share of (token, slot) choices "
             f"shared): first {sh[0]:.4f}, min {min(sh):.4f}, mean {sum(sh) / len(sh):.4f} "
             f"[{' '.join(f'{x:.3f}' for x in sh)}]")
    line(f"  routing limits: first layer {ROUTE_FIRST}; every layer {route_any:.4f} (the "
         f"witness's min {min(witness):.4f} less {ROUTE_MARGIN}); the witness at every layer "
         f"{ROUTE_FLOOR}")
    line(f"  prefill logits, kernel path vs ref on the card: rows routed alike at every layer "
         f"{int(rows_agree.sum())}/{b * s}, their rel_err={rows:.3e}"
         + ("" if scan else " (limit 4e-2)")
         + f"; whole tensor rel_err={whole:.3e}; ref routed as the kernel path: "
         f"rel_err={same_routes:.3e} (limit 4e-2); finite={finite}; max|logit|={scale:.3f}")
    line(f"  tokens whose whole prefix was routed alike at every layer {int(prefix.sum())}/"
         f"{b * s}, their rel_err={prefix_err:.3e}"
         + (" (limit 4e-2, the Mamba scan's rows)" if scan else ""))
    line(f"  plain K4 (witness) vs ref: rows routed alike at every layer "
         f"{int(plain_agree.sum())}/{b * s}, their rel_err={plain_rows:.3e}; tokens whose whole "
         f"prefix was {int(plain_prefix.sum())}/{b * s}, their rel_err={plain_prefix_err:.3e} "
         "(printed beside the kernel path's: no kernel in it)")
    if scan:
        rows = prefix_err
    if not (finite and shares[0] >= ROUTE_FIRST and witness[0] >= ROUTE_FIRST
            and min(witness) >= ROUTE_FLOOR and min(shares) >= route_any
            and rows <= 4e-2 and same_routes <= 4e-2):
        raise AssertionError(f"serve {arch}: routing agreement ({shares[0]:.4f} first, "
                             f"{min(shares):.4f} min; witness {witness[0]:.4f} first, "
                             f"{min(witness):.4f} min) or logits ({rows:.3e}, "
                             f"{same_routes:.3e}) off the ref path")
    return rows, same_routes


# The profiler ranges of a serving run (`profiled_ranges`): the prefill step,
# each decode step, each MoE FFN call and each Mamba mixer call (named by
# its sequence length: prefill T 512, decode T 1).
STEP_RANGES = ("prefill", "decode_step")


def is_range(key: str) -> bool:
    return key in STEP_RANGES or key == "moe_apply" or key.startswith("mamba T=")


def range_shares(ranges: dict, busy_us: float) -> None:
    """Per range name of `profiled_ranges` (`read_trace`'s ranges): its
    calls, the kernels launched inside them and their device time, printed
    with its share of the profiled run's device time."""
    labels = {"moe_apply": "MoE FFN", "prefill": "prefill step", "decode_step": "decode step"}
    for name, (calls, n, us) in ranges.items():
        label = labels.get(name, "Mamba mixer")
        if n == 0:
            line(f"  {label} share of device time: not measured ({calls} {name} ranges, no "
                 "kernel linked to them in this trace)")
            continue
        line(f"  {label} ({calls} {name} calls): device_ms={us / 1e3:.2f} share of device "
             f"time {us / (busy_us or float('nan')):.4f}; kernels {n} ({n / calls:.1f} per "
             f"{name} call)")


class profiled_ranges:
    """Inside `with`, the serving run's prefill step, decode steps, MoE FFN
    calls and Mamba mixer calls each run under a profiler range."""

    def __enter__(self):
        from torch.profiler import record_function

        def ranged(fn, name_of):
            def wrapper(*args, **kw):
                with record_function(name_of(*args)):
                    return fn(*args, **kw)
            return wrapper

        self.real = (tf_mod.moe_apply, tf_mod.mamba_forward, serve_mod.make_prefill_step,
                     serve_mod.make_serve_step)
        moe, mamba, prefill, step = self.real
        tf_mod.moe_apply = ranged(moe, lambda *a: "moe_apply")
        tf_mod.mamba_forward = ranged(mamba, lambda p, cfg, x, *rest: f"mamba T={x.shape[1]}")
        serve_mod.make_prefill_step = lambda *a, **kw: ranged(prefill(*a, **kw),
                                                             lambda *_: "prefill")
        serve_mod.make_serve_step = lambda *a, **kw: ranged(step(*a, **kw),
                                                           lambda *_: "decode_step")

    def __exit__(self, *exc) -> None:
        (tf_mod.moe_apply, tf_mod.mamba_forward, serve_mod.make_prefill_step,
         serve_mod.make_serve_step) = self.real


def check_frontend(cfg, b: int = SERVE["batch"], s: int = SERVE["prompt_len"]) -> dict:
    """The audio and VLM families' inputs for the prefill logits check, on
    the card, from a seed: encoder frames (B, encoder_seq, d) of unit
    scale, or patch embeddings (B, n_patches, d) of scale 0.02 with the
    prompt's 3-D M-RoPE grid (`mrope_grid`).  serve_loop's own stubs (zero
    frames or patches, M-RoPE arange on all three streams, where M-RoPE is
    RoPE) would not exercise these paths."""
    gen = torch.Generator(DEV).manual_seed(SERVE["seed"] + 1)
    if cfg.family == "audio":
        return {"enc_frames": torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=gen,
                                          device=DEV).bfloat16()}
    if cfg.family == "vlm":
        return {"image_embeds": (0.02 * torch.randn(b, cfg.n_patches, cfg.d_model,
                                                    generator=gen, device=DEV)).bfloat16(),
                "mrope_pos": mrope_grid(b, s, cfg.n_patches, DEV)}
    return {}


def serve_phase(arch: str, kernel: str, expect: int, *, layers: int = 0,
                full: bool = True, variants: tuple = ()) -> dict:
    """Serve `arch` at full width on the kernel path, at full depth or cut
    to `layers`: random weights from the seed, the launch counters set to 0
    just before serve_loop and read just after; `kernel` must have launched
    exactly `expect` times and no other kernel at all.  Then prefill logits
    on the kernel path against the "ref" path on the same weights and
    prompt (4e-2 of the scale, the JAX package's serving tolerance; an MoE
    arch by `moe_logits_check`; not where the run launched no kernel, as
    the two paths then run the same code; the audio and VLM families on
    `check_frontend`'s inputs).  With `full`, a warm second run under
    torch's sync debug mode (every host sync, by source line; none may come
    from the model's code, which the decode loop runs) and a third, of
    PROFILE_TOKENS new tokens, under torch.profiler (the card's busy time
    and idle share; kernels per prefill and per decode step; an MoE arch's
    and a Mamba arch's share of it).  `variants`, (label, config fields),
    are served after that from the same weights, each with its counters
    and, with `full`, its own warm run under sync debug mode (deepseek's
    absorbed MLA decode)."""
    base = get_config(arch)
    if layers:
        base = dataclasses.replace(base, n_layers=layers)
    cfg = dataclasses.replace(base, attn_impl="pallas", rwkv_wkv_impl="pallas")
    ref_cfg = dataclasses.replace(base, attn_impl="ref", rwkv_wkv_impl="ref")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(SERVE["seed"]))
    torch.cuda.synchronize()
    n_params = param_count(params)
    # Read by the dry-run phase (`dryrun_phase`) against the meta prediction.
    memory = dict(param_bytes=tree_nbytes(params),
                  init_growth=torch.cuda.memory_allocated() - before)
    line(f"serve {arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers): init_params "
         f"{time.perf_counter() - t0:.2f}s; params={n_params}; memory allocated "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, max_memory_allocated during init "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD}")

    def served(run_cfg, label: str):
        for fn in COUNTERS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = serve_loop(run_cfg, device=DEV, params=params, **SERVE)
        wall = time.perf_counter() - t0
        memory.setdefault("serve_peak", torch.cuda.max_memory_allocated())
        memory.setdefault("cache_bytes", res.cache_bytes)
        launches = {name: fn.launches for name, fn in COUNTERS.items()}
        line(f"main path serve {label} (kernel path) B={SERVE['batch']} "
             f"prompt={SERVE['prompt_len']} new_tokens={SERVE['new_tokens']}: launches "
             + " ".join(f"{k}={v}" for k, v in launches.items())
             + f"; first run wall_s={wall:.3f} prefill_s={res.prefill_s:.4f} "
             f"({res.prefill_tok_s:.0f} tok/s) decode_s={res.decode_s:.4f} "
             f"({res.decode_tok_s:.1f} tok/s, {res.decode_s / SERVE['new_tokens'] * 1e3:.3f} "
             f"ms/step); max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
             f"GiB; {CARD}")
        if launches[kernel] != expect:
            raise AssertionError(f"serve {label}: {kernel} launched {launches[kernel]} times, "
                                 f"expected {expect}")
        others = [k for k, v in launches.items() if v and k != kernel]
        if others:
            raise AssertionError(f"serve {label}: unexpected kernels launched: {others}")
        toks = res.tokens
        if not (toks.shape == (SERVE["batch"], SERVE["new_tokens"] + 1)
                and ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"serve {label}: generated tokens out of range / wrong shape")
        return res, launches

    def warm_run(run_cfg, label: str, first):
        warm, by_line = sync_counted(lambda: serve_loop(run_cfg, device=DEV, params=params,
                                                        log_every=SERVE["new_tokens"], **SERVE))
        syncs = sum(by_line.values())
        in_model = [k for k in by_line if not k.startswith("serve.py:")]
        line(f"  warm run {label}: prefill_s={warm.prefill_s:.4f} ({warm.prefill_tok_s:.0f} "
             f"tok/s) decode_s={warm.decode_s:.4f} ({warm.decode_tok_s:.1f} tok/s, "
             f"{warm.decode_s / SERVE['new_tokens'] * 1e3:.3f} ms/step); same tokens as the "
             f"first run: {bool(np.array_equal(warm.tokens, first.tokens))}; {syncs} "
             "synchronizing calls: "
             + ", ".join(f"{k} x{v}" for k, v in by_line.most_common(6))
             + f"; in the model's code (the decode loop's): {len(in_model)}")
        if in_model:
            raise AssertionError(f"serve {label}: host syncs in the model's code: {in_model}")
        return warm

    first, launches = served(cfg, arch)
    toks = first.tokens
    prompt = synthetic_token_batch(np.random.default_rng(SERVE["seed"]), SERVE["batch"],
                                   SERVE["prompt_len"], cfg.vocab)["tokens"]
    batch = {"tokens": torch.from_numpy(prompt).to(DEV), **check_frontend(cfg)}
    if not any(launches.values()):
        # No kernel ran, so the kernel path and "ref" run the same code
        # (deepseek's MLA never reaches K4): the full-width layer against
        # the CPU (`full_width_layers`) is this arch's check.
        err = None
        line(f"  prefill logits, kernel path vs ref: not compared, no kernel launched on "
             f"{arch}'s path, so the two paths run the same code")
    elif cfg.n_experts:
        err, _ = moe_logits_check(arch, cfg, ref_cfg, params, batch)
    else:
        got = forward(cfg, params, batch)[0]
        want = forward(ref_cfg, params, batch)[0]
        finite = (bool(torch.isfinite(got.float()).all())
                  and bool(torch.isfinite(want.float()).all()))
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        same_next = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean())
        line(f"  prefill logits, kernel path vs ref on the card: rel_err={err:.3e} (limit "
             f"4e-2); finite={finite}; max|logit|={float(want.float().abs().max()):.3f}; same "
             f"next token {same_next:.2f}; first decoded row: {toks[0, :8].tolist()}")
        del got, want
        if not (finite and err <= 4e-2):
            raise AssertionError(f"serve {arch}: prefill logits off the ref path ({err:.3e})")
    out = dict(launches=launches, first=first, warm=None, err=err, params=n_params,
               variants={}, memory=memory, layers=cfg.n_layers)
    if full:
        out["warm"] = warm_run(cfg, arch, first)
        out["profile"] = profile_serve(cfg, params)
    for label, kw in variants:
        run_cfg = dataclasses.replace(cfg, **kw)
        res, v_launches = served(run_cfg, f"{arch} {label}")
        same = float((res.tokens == toks).mean())
        line(f"  {label} against the first run's tokens: {same:.3f} equal; decode "
             f"{res.decode_s / SERVE['new_tokens'] * 1e3:.3f} against "
             f"{first.decode_s / SERVE['new_tokens'] * 1e3:.3f} ms/step")
        out["variants"][label] = dict(first=res, launches=v_launches,
                                      warm=warm_run(run_cfg, f"{arch} {label}", res)
                                      if full else None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_serve(cfg, params) -> dict:
    """A run of PROFILE_TOKENS new tokens under torch.profiler: the card's
    busy time and idle share, the kernels by time, and per range
    (`profiled_ranges`) its kernels and device time; returns the kernels
    per prefill and per decode step."""
    from torch.profiler import ProfilerActivity, profile
    # The profiled run decodes fewer tokens than SERVE (PROFILE_TOKENS).
    prof_serve = dict(SERVE, new_tokens=PROFILE_TOKENS)
    with profiled_ranges(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_run = serve_loop(cfg, device=DEV, params=params,
                              log_every=prof_serve["new_tokens"], **prof_serve)
        prof_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels, ranges = read_trace(prof)
    # The device-side copies of user ranges span their kernels.
    kernels = [k for k in kernels if not is_range(k.key)]
    busy_ms = sum(k.us for k in kernels) / 1e3
    n_launch = sum(k.count for k in kernels)
    steps = prof_serve["new_tokens"] + 2
    line(f"  profile (profiled run, {prof_serve['new_tokens']} new tokens): wall_s={prof_wall:.3f} "
         f"prefill_s={prof_run.prefill_s:.4f} decode_s={prof_run.decode_s:.4f} "
         f"device_busy_ms={busy_ms:.2f} device_idle_share={1 - busy_ms / 1e3 / prof_wall:.4f} "
         f"kernel_launches={n_launch} (~{n_launch / steps:.0f} per step)")
    for k in sorted(kernels, key=lambda k: -k.us)[:8]:
        line(f"  {k.us / 1e3:9.3f} ms  {k.count:6d}x  {k.key[:90]}")
    range_shares(ranges, busy_ms * 1e3)
    per = {name: ranges[name][1] / ranges[name][0] for name in STEP_RANGES if name in ranges}
    line(f"  kernels per prefill {per.get('prefill', float('nan')):.0f}, per decode step "
         f"{per.get('decode_step', float('nan')):.1f} (warm-up step included)")
    line(f"  profile read back in {time.perf_counter() - t0:.1f}s")
    del prof
    return dict(idle=1 - busy_ms / 1e3 / prof_wall, launches=n_launch, per=per,
                ranges={k: v[:2] for k, v in ranges.items()})


# The zoo phase: the four archs this slice serves, at batch 4, prompt 512,
# 32 new tokens (SERVE), each freed before the next loads, the largest
# last: (arch, layers (0: full depth), full serve_phase).  qwen1.5-110b's
# 80 layers (222 GB in bf16) do not fit one card; 16 (48.5 GB) do.
ZOO = (("granite-moe-3b-a800m", 0, True), ("stablelm-3b", 0, False),
       ("yi-6b", 0, False), ("qwen1.5-110b", 16, False))


def zoo_phase() -> dict:
    t0 = time.perf_counter()
    out = {}
    for arch, layers, full in ZOO:
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        line(f"zoo {arch}: memory allocated before init {torch.cuda.memory_allocated() / 2**30:.2f}"
             " GiB")
        cfg = get_config(arch)
        out[arch] = serve_phase(arch, "flash_attention", layers or cfg.n_layers, layers=layers,
                                full=full)
        out[arch]["head_dim"] = cfg.head_dim
        line(f"zoo {arch}: wall_s={time.perf_counter() - t_arch:.1f}")
    line(f"zoo phase wall_s={time.perf_counter() - t0:.1f} on {CARD}")
    return out


# The MLA and Mamba phase: deepseek-v3-671b at 5 of its 61 layers (the 3
# dense and 2 MoE layers: 27.5 B parameters, 55.1 GB in bf16; a third MoE
# layer adds 23 GB) served with the naive and the absorbed MLA decode from
# the same weights, then jamba-v0.1-52b at 8 of its 32 layers (one period
# of 8: 13.3 B, 26.6 GB; 16 layers took ~84 s of a slow host's run, its
# 23 090-kernel prefill trace the most), each freed before the next loads:
# (arch, layers, K4 launches expected, variants).  MLA never reaches K4
# (its q/k width 192 and v width 128; the JAX package's mla_forward runs
# `_full_attn` too); jamba's attention layer (layer 4 of the period)
# launches it once.
MLA_MAMBA = (("deepseek-v3-671b", 5, 0, (("absorbed", {"mla_absorb": True}),)),
             ("jamba-v0.1-52b", 8, 1, ()))
LAYER_TOL = 2e-2       # bf16 layer, card against CPU, of the scale


def layer_vs_cpu(label: str, fn_card, fn_cpu) -> None:
    """Run one layer's outputs on the card and on the CPU from the same
    weights and inputs; each output within LAYER_TOL of the scale."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn_card()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fn_cpu()
    cpu_s = time.perf_counter() - t0
    errs = {}
    for name in want:
        g, w = got[name].float().cpu(), want[name].float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} {name}: not finite on the card")
        errs[name] = float((g - w).abs().max() / w.abs().max())
    line(f"{label}, card vs cpu (bf16): " + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
         + f" (limit {LAYER_TOL}); card {card_s:.3f}s (first call), cpu {cpu_s:.2f}s; {CARD}")
    if max(errs.values()) > LAYER_TOL:
        raise AssertionError(f"{label}: card off the CPU ({errs})")


def full_width_layers() -> None:
    """One MLA layer of deepseek-v3-671b (prefill B 1 x S 512, then one
    naive and one absorbed decode step at position 512) and one Mamba layer
    of jamba-v0.1-52b (prefill B 1 x S 512, then one decode step) at full
    width on the card against the port's own CPU path, same weights (drawn
    on the card from the seed, copied to the CPU) and inputs."""
    from repro_torch.models import attention as attn, ssm
    ds, jb = get_config("deepseek-v3-671b"), get_config("jamba-v0.1-52b")
    s = SERVE["prompt_len"]

    def copy(tree, dev):
        return tree_map(lambda t: t.to(dev), tree)

    p_mla = attn.mla_init(torch.Generator(DEV).manual_seed(1), ds)
    x = torch.randn(1, s + 1, ds.d_model, generator=torch.Generator().manual_seed(2)).bfloat16()
    pos = torch.tensor(s, dtype=torch.int32)

    def mla(p, dev):
        out = {}
        y, (c_kv, k_pe) = attn.mla_forward(p, ds, x[:, :s].to(dev), return_kv=True)
        out.update(prefill_y=y, c_kv=c_kv, k_pe=k_pe)
        for mode in ("naive", "absorbed"):
            cfg = dataclasses.replace(ds, mla_absorb=mode == "absorbed")
            cache = attn.init_mla_cache(cfg, 1, s + 1, dev)
            cache["c_kv"][:, :s], cache["k_pe"][:, :s] = c_kv, k_pe
            cache["pos"][:s] = torch.arange(s, dtype=torch.int32, device=dev)
            cache["idx"].fill_(s)
            out[f"{mode}_decode_y"], cache = attn.mla_decode(p, cfg, x[:, s:].to(dev), cache,
                                                             pos.to(dev))
            out[f"{mode}_c_kv"] = cache["c_kv"]
        return out

    layer_vs_cpu(f"full-width MLA layer (deepseek-v3-671b, 128 heads, B 1 x S {s}, then "
                 "naive and absorbed decode)", lambda: mla(p_mla, DEV),
                 lambda: mla(copy(p_mla, "cpu"), "cpu"))
    del p_mla
    p_mamba = ssm.mamba_init(torch.Generator(DEV).manual_seed(3), jb)
    xm = torch.randn(1, s + 1, jb.d_model, generator=torch.Generator().manual_seed(4)).bfloat16()

    def mamba(p, dev):
        y, st = ssm.mamba_forward(p, jb, xm[:, :s].to(dev))
        y1, st1 = ssm.mamba_decode(p, jb, xm[:, s:].to(dev), st)
        return dict(prefill_y=y, ssm=st["ssm"], conv=st["conv"], decode_y=y1,
                    decode_ssm=st1["ssm"])

    layer_vs_cpu(f"full-width Mamba layer (jamba-v0.1-52b, d_inner 8192, N 16, B 1 x S {s}, "
                 "then one decode step)", lambda: mamba(p_mamba, DEV),
                 lambda: mamba(copy(p_mamba, "cpu"), "cpu"))
    del p_mamba
    gc.collect()
    torch.cuda.empty_cache()


def mla_mamba_phase() -> dict:
    t0 = time.perf_counter()
    full_width_layers()
    out = {}
    for arch, layers, expect, variants in MLA_MAMBA:
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        line(f"{arch}: memory allocated before init {torch.cuda.memory_allocated() / 2**30:.2f}"
             " GiB")
        out[arch] = serve_phase(arch, "flash_attention", expect, layers=layers,
                                variants=variants)
        line(f"{arch}: wall_s={time.perf_counter() - t_arch:.1f}")
    line(f"MLA and Mamba phase wall_s={time.perf_counter() - t0:.1f} on {CARD}")
    return out


# The audio and VLM phase: whisper-base (6 encoder + 6 decoder layers; K4
# on the decoder's 6 self-attentions, the encoder's non-causal attention
# and the cross-attentions through the plain path, as in the JAX package)
# and qwen2-vl-2b (28 layers, K4 on each), both at full depth: (arch, K4
# launches expected).  Both are small (0.11 B and 1.78 B parameters).
AUDIO_VLM = (("whisper-base", 6), ("qwen2-vl-2b", 28))


def audio_vlm_layers() -> None:
    """One whisper-base decoder sublayer (self-attention with the kernel
    path's K4, cross-attention over 1 500 encoder frames, SwiGLU; prefill
    B 4 x S 512, then one decode step at position 512), one whisper-base
    encoder layer (B 4 x 1 500 frames) and one qwen2-vl-2b attention layer
    on the 3-D M-RoPE grid (prefill B 4 x S 512 with the 16 x 16 patch
    grid, then one decode step) at full width on the card against the
    port's own CPU path, same weights (drawn on the card from the seed,
    copied to the CPU) and inputs."""
    from repro_torch.models import attention as attn
    wh = dataclasses.replace(get_config("whisper-base"), attn_impl="pallas")
    vl = dataclasses.replace(get_config("qwen2-vl-2b"), attn_impl="pallas")
    b, s = SERVE["batch"], SERVE["prompt_len"]
    cpu_gen = torch.Generator().manual_seed(6)

    def copy(tree, dev):
        return tree_map(lambda t: t.to(dev), tree)

    kind = tf_mod.LayerKind("attn", "dense", cross=True)
    p_dec = tf_mod._init_sublayer(torch.Generator(DEV).manual_seed(5), wh, kind)
    x = torch.randn(b, s + 1, wh.d_model, generator=cpu_gen).bfloat16()
    enc = torch.randn(b, wh.encoder_seq, wh.d_model, generator=cpu_gen).bfloat16()

    def decoder(p, dev):
        ex = tf_mod._Extras(positions=torch.arange(s, dtype=torch.int32, device=dev)[None],
                            enc_out=enc.to(dev))
        y, _, got = tf_mod._sublayer_full(wh, kind, p, x[:, :s].to(dev), ex, True)
        cache = attn.init_kv_cache(wh, b, s + 1, dev)
        cache = {name: t[None] for name, t in cache.items()}
        cache["k"][0, :, :s], cache["v"][0, :, :s] = got["k"], got["v"]
        cache["pos"][0, :s] = torch.arange(s, dtype=torch.int32, device=dev)
        cache["idx"].fill_(s)
        y1 = tf_mod._sublayer_decode(wh, kind, p, x[:, s:].to(dev), cache, 0,
                                     torch.tensor(s, dtype=torch.int32, device=dev), ex)
        return dict(prefill_y=y, k=got["k"], v=got["v"], decode_y=y1, decode_k=cache["k"][0])

    layer_vs_cpu(f"full-width whisper-base decoder sublayer (K4 self-attention, then "
                 f"cross-attention over {wh.encoder_seq} frames; B {b} x S {s}, then one "
                 "decode step)", lambda: decoder(p_dec, DEV),
                 lambda: decoder(copy(p_dec, "cpu"), "cpu"))
    del p_dec
    p_enc = tf_mod._init_sublayer(torch.Generator(DEV).manual_seed(7), wh, tf_mod.ENCODER_KIND)
    layer_vs_cpu(f"full-width whisper-base encoder layer (non-causal, B {b} x "
                 f"{wh.encoder_seq} frames)",
                 lambda: dict(y=tf_mod._encoder_layer(wh, p_enc, enc.to(DEV))),
                 lambda: dict(y=tf_mod._encoder_layer(wh, copy(p_enc, "cpu"), enc)))
    del p_enc
    p_vl = attn.gqa_init(torch.Generator(DEV).manual_seed(8), vl)
    xv = torch.randn(b, s + 1, vl.d_model, generator=cpu_gen).bfloat16()
    grid = mrope_grid(b, s + 1, vl.n_patches)

    def mrope_layer(p, dev):
        y, (k, v) = attn.gqa_forward(p, vl, xv[:, :s].to(dev), mrope_pos=grid[:, :s].to(dev),
                                     return_kv=True)
        cache = attn.init_kv_cache(vl, b, s + 1, dev)
        cache["k"][:, :s], cache["v"][:, :s] = k, v
        cache["pos"][:s] = torch.arange(s, dtype=torch.int32, device=dev)
        cache["idx"].fill_(s)
        y1, cache = attn.gqa_decode(p, vl, xv[:, s:].to(dev), cache,
                                    torch.tensor(s, dtype=torch.int32, device=dev),
                                    mrope_pos=grid[:, s:].to(dev))
        return dict(prefill_y=y, k=k, v=v, decode_y=y1, decode_k=cache["k"])

    layer_vs_cpu(f"full-width qwen2-vl-2b attention layer (K4, M-RoPE on the "
                 f"{math.isqrt(vl.n_patches)} x {math.isqrt(vl.n_patches)} patch grid; B {b} x "
                 f"S {s}, then one decode step)", lambda: mrope_layer(p_vl, DEV),
                 lambda: mrope_layer(copy(p_vl, "cpu"), "cpu"))
    del p_vl
    gc.collect()
    torch.cuda.empty_cache()


def audio_vlm_phase() -> dict:
    """K4 at the two families' prefill shapes, their full-width layers
    against the CPU, then each arch served (`serve_phase`, full); returns
    {"k4": {label: check_k4's bf16 result}, "serve": {arch: serve_phase}}."""
    t0 = time.perf_counter()
    k4 = {}
    b, s = SERVE["batch"], SERVE["prompt_len"]
    for label, arch in (("whisper_d64", "whisper-base"), ("qwen2_vl_d128", "qwen2-vl-2b")):
        cfg = get_config(arch)
        shape = (b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0)
        k4[label] = check_k4(*shape, torch.bfloat16, f"{arch} prefill on {CARD}", reps=20)
        check_k4(*shape, torch.float32, f"{arch} prefill", reps=10)
    audio_vlm_layers()
    out = {}
    for arch, expect in AUDIO_VLM:
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = serve_phase(arch, "flash_attention", expect)
        line(f"{arch}: wall_s={time.perf_counter() - t_arch:.1f}")
    line(f"audio and VLM phase wall_s={time.perf_counter() - t0:.1f} on {CARD}")
    return {"k4": k4, "serve": out}


# The training phase: train_loop's defaults (batch 8, lr 3e-4) with fl=True,
# its donated step (parameters and AdamW's moments updated in place), at
# full width with the depth cut so that bf16 weights and gradients and
# AdamW's two f32 moments fit the card (PERF.md section 4): (arch, layers,
# steps, seq).  deepseek-v3-671b trains its 3 dense layers and the MTP head
# (its 4th layer, the first MoE one, would take ~179 GiB with AdamW's
# state); jamba-v0.1-52b its first two (Mamba with the dense FFN, then with
# the MoE FFN; its attention layer is the 5th); qwen2-vl-2b trains at seq
# 512, since a sequence shorter than its 256 patches raises, on seeded
# patch embeddings (`train_frontend`).  granite-moe-3b-a800m trains at its
# full depth, stablelm-3b and yi-6b at theirs, which the dry run admits
# (predicted peaks 38.84, 33.16 and 71.64 GiB, under 72).
TRAIN = dict(batch=8, lr=3e-4, seed=0)
TRAIN_RUNS = (("qwen2-7b", 4, 10, 128), ("rwkv6-7b", 2, 8, 128),
              ("deepseek-v3-671b", 3, 8, 128), ("jamba-v0.1-52b", 2, 8, 128),
              ("whisper-base", 6, 8, 128), ("qwen2-vl-2b", 28, 8, 512),
              ("granite-moe-3b-a800m", 32, 8, 128), ("stablelm-3b", 32, 8, 128),
              ("yi-6b", 32, 12, 128))
# The dry run's train step on the card: make_train_step(cfg,
# make_optimizer(cfg.optimizer, lr), donate=True), remat on, as
# `launch.dryrun.build_step` builds it: the donated Adafactor.  deepseek-v3
# at 4 layers (its first MoE layer), jamba at 5 (its attention layer),
# qwen1.5-110b at 10 of 80 (the most whose predicted peak stays under 72
# GiB): predicted peaks 66.71, 29.32 and 69.21 GiB.  Adafactor moves every
# element by about lr a step (u's RMS is clipped to 1), which at these
# widths moves the logits by width x lr: at the JAX dry run's lr 1e-4 the
# first steps overshoot (losses up to 39-66 from 11.7-17.1 in 8 steps), at
# 1e-5 they fall: (arch, layers, steps, seq, lr).
ADAFACTOR_RUNS = (("deepseek-v3-671b", 4, 10, 128, 1e-5), ("jamba-v0.1-52b", 5, 10, 128, 1e-5),
                  ("qwen1.5-110b", 10, 10, 128, 1e-5))
# The runs whose loss traces predate the donated step: each is run again on
# the functional step, and the two traces must be equal to the bit.
TRAIN_TRACE_REFS = ("qwen2-7b", "rwkv6-7b")
# The runs since the donated Adafactor: their max_memory_allocated is held
# under the dry run's predicted peak plus phase 16's growth allowance.
PEAK_GATED = ("granite-moe-3b-a800m", "stablelm-3b", "yi-6b",
              *(f"{arch}/adafactor" for arch, *_ in ADAFACTOR_RUNS))


def patched_train_loop(cfg, *, optimizer: str | None = None, step_kw: dict | None = None,
                       **kw):
    """train_loop with `step_kw` overriding its make_train_step keywords
    and, where `optimizer` is given, make_optimizer(optimizer) in place of
    the optimizer train_loop picks."""
    real_step, real_opt = train_mod.make_train_step, train_mod.make_optimizer

    def make_step(*args, **step_args):
        return real_step(*args, **{**step_args, **(step_kw or {})})

    train_mod.make_train_step = make_step
    if optimizer is not None:
        train_mod.make_optimizer = lambda _, lr: real_opt(optimizer, lr)
    try:
        return train_loop(cfg, **kw)
    finally:
        train_mod.make_train_step, train_mod.make_optimizer = real_step, real_opt


def train_run(arch: str, layers: int, steps: int, seq: int, adafactor: bool = False,
              lr: float = TRAIN["lr"]) -> dict:
    """train_loop(fl=True) at full width and `layers` layers on the card,
    random weights from the seed, under torch's sync debug mode, with every
    launch counter set to 0 just before it and read just after (training
    runs the "ref" paths: no kernel of the port launches); with
    `adafactor` the loop runs the dry run's step instead (the config's
    optimizer, Adafactor, donated, remat on), at learning rate `lr`.
    Returns those launch counts and the memory phase 16 reads."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    kw = dict(steps=steps, fl=True, device=DEV, log_every=steps, seq=seq,
              frontend=train_frontend(cfg, TRAIN["batch"], seq, DEV), **{**TRAIN, "lr": lr})
    step_kw = dict(remat=True) if adafactor else None
    opt_name = cfg.optimizer if adafactor else "adamw"
    label = "Adafactor, donated step, remat: the dry run's step" if adafactor else (
        "AdamW, donated step")
    for fn in COUNTERS.values():
        fn.launches = 0
    # No empty_cache between the runs: with expandable segments it unmaps
    # the free pages, and each run would map them again (~40 GB/s).
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, by_line = sync_counted(lambda: patched_train_loop(
        cfg, optimizer=opt_name if adafactor else None, step_kw=step_kw, **kw))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN["batch"] * seq
    warm = res.step_s[2:]                      # the first two steps warm the card up
    step_ms = 1e3 * sum(warm) / len(warm)
    tflops = 6 * res.n_params * tokens / (step_ms / 1e3) / 1e12
    # The cost model's count: 3x the forward's matmuls, attention and LM
    # head included, embedding gathers not (6*P*tokens counts the embedding
    # table's parameters as FLOPs and leaves attention out).
    train_flops = model_flops(cfg, InputShape("train", seq, TRAIN["batch"], "train"))["train_total"]
    model_tflops = train_flops / (step_ms / 1e3) / 1e12
    n_sync = sum(by_line.values())
    line(f"main path train {arch} (full width, {layers} layers, fl=True, {label}, lr {lr:g}) "
         f"on {CARD}: params={res.n_params} ({res.n_params / 1e9:.3f} B) B={TRAIN['batch']} "
         f"seq={seq} steps={steps}: warm ms/step={step_ms:.2f} (steps 2-{steps - 1}; "
         f"first {1e3 * res.step_s[0]:.1f}, second {1e3 * res.step_s[1]:.1f}) "
         f"tokens/s={tokens / (step_ms / 1e3):.0f} model TFLOP/s (6*P*tokens/time)="
         f"{tflops:.2f} = {tflops / (PEAK_OPS[torch.bfloat16] / 1e12):.4f} of the dense bf16 peak; "
         f"model TFLOP/s (model_flops train_total={train_flops:.4e} / time)={model_tflops:.2f} "
         f"= {model_tflops / (PEAK_OPS[torch.bfloat16] / 1e12):.4f} of the peak; "
         f"max_memory_allocated={peak / 2**30:.2f} GiB; wall_s={wall:.2f}")
    line(f"  host syncs: {n_sync} in {steps} steps ({n_sync / steps:.2f} per step): "
         + ", ".join(f"{k} x{v}" for k, v in by_line.most_common(6)))
    line("  loss trace: " + " ".join(f"{x:.4f}" for x in res.losses))
    line("  grad-norm trace: " + " ".join(f"{x:.3f}" for x in res.grad_norms))
    line("  kernel launches on the training path: "
         + " ".join(f"{k}={v}" for k, v in launches.items()))
    first, last = np.mean(res.losses[:3]), np.mean(res.losses[-3:])
    if not np.all(np.isfinite(res.losses)) or not last < first:
        raise AssertionError(f"train {arch}: losses not finite or not falling "
                             f"(first 3 mean {first:.4f}, last 3 mean {last:.4f})")
    if any(launches.values()):
        raise AssertionError(f"train {arch}: a kernel launched on the training path: {launches}")
    if arch in TRAIN_TRACE_REFS and not adafactor:
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ref = patched_train_loop(cfg, step_kw={"donate": False}, **kw)
        same = ref.losses == res.losses and ref.grad_norms == res.grad_norms
        line(f"  the functional step (donate=False) from the same seed: loss and grad-norm "
             f"traces bitwise equal to the donated step's: {same}; its max_memory_allocated="
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB against the donated "
             f"{peak / 2**30:.2f} GiB [{CARD}]")
        if not same:
            raise AssertionError(f"train {arch}: the donated step's traces differ from the "
                                 "functional step's")
    memory = profile_step(cfg, arch, seq, opt_name, remat=adafactor)
    memory.update(train_peak=peak, step_ms=step_ms, layers=layers, seq=seq, arch=arch,
                  optimizer=opt_name, remat=adafactor)
    return dict(launches=launches, memory=memory)


def train_frontend(cfg, batch: int, seq: int, device) -> dict:
    """The modality inputs of the training runs: the VLM's from a seed
    (`check_frontend`: patch embeddings of scale 0.02 on the 3-D M-RoPE
    grid), since the JAX package's stub of zero patches makes qwen2-vl-2b's
    gradient non-finite at its full depth, in both packages
    (`launch/train.py`); the audio family's the stub's zero frames, as
    train_loop makes them."""
    if cfg.family == "vlm":
        return {k: v.to(device) for k, v in check_frontend(cfg, batch, seq).items()}
    return serve_mod.stub_frontend(cfg, batch, seq, device)


def train_batch(cfg, batch: int, seq: int, seed: int, device) -> dict:
    """A synthetic token batch with the training runs' frontend
    (`train_frontend`) and unit cohort weights, on `device`."""
    b = synthetic_token_batch(np.random.default_rng(seed), batch, seq, cfg.vocab)
    return {"tokens": torch.from_numpy(b["tokens"]).to(device),
            "labels": torch.from_numpy(b["labels"]).to(device),
            "fl_weights": torch.ones(batch, device=device),
            **train_frontend(cfg, batch, seq, device)}


def profile_step(cfg, arch: str, seq: int, opt_name: str = "adamw",
                 remat: bool = False) -> dict:
    """Where a warm training step's time goes: one donated make_train_step
    (`opt_name`, `remat`) under torch.profiler, then the optimizer's
    in-place update alone on the same state, from gradients in the
    parameters' dtype (Adafactor's pass 1 with a clip scale, as the step
    runs it; AdamW's leaf updates on them as they are, since the
    step's float32 copy of a 6 B-parameter model's gradient would not
    fit beside it).
    Returns the memory the dry-run phase reads: the parameters' bytes, and
    memory_allocated's growth over init_params and over init_params, the
    optimizer's init and one step (the steady state: parameters, the
    optimizer's state, the batch)."""
    gc.collect()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(TRAIN["seed"]))
    memory = dict(param_bytes=tree_nbytes(params),
                  init_growth=torch.cuda.memory_allocated() - before)
    opt = make_optimizer(opt_name, TRAIN["lr"])
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat=remat, donate=True)
    batch = train_batch(cfg, TRAIN["batch"], seq, 2, DEV)
    params, state, metrics = step(params, state, batch)              # warm
    torch.cuda.synchronize()
    del metrics
    memory["steady_growth"] = torch.cuda.memory_allocated() - before
    name = {"adamw": "AdamW", "adafactor": "Adafactor"}[opt_name]
    profile_call(f"train step {arch} (warm, {name}, donated) on {CARD}",
                 lambda: step(params, state, batch), focus=("gemm", "nvjet", "elementwise"))
    grads = [torch.full_like(p, 1e-3) for p in tree_leaves(params)]
    scale = torch.full((), 0.5, device=DEV)

    def update_alone():
        donation = opt.donate(state, params)
        if donation.first is not None:
            donation.first(grads, scale)
        for update, g in zip(donation.updates, grads):
            update(g)

    profile_call(f"  of which {name}'s in-place update alone ({arch})", update_alone,
                 focus=("elementwise", "reduce"))
    del params, state, grads, batch
    gc.collect()
    return memory


def same_bits(a, b) -> bool:
    """Two trees of tensors (or numbers) with the same leaves, equal to the
    bit, dtypes included."""
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


# make_train_step(donate=True) against donate=False on the card: the four
# families' smoke configs (batch 8, seq 32) and qwen2-7b at full width with
# 1 layer (train_loop's batch 8, seq 128), 3 AdamW steps from opt.init;
# with Adafactor the same and jamba-v0.1-52b at full width with 2 layers,
# whose functional Adafactor step fits the card: (arch, layers, seq).
DONATE_CASES = (("deepseek-v3-671b-smoke", 0, 32), ("jamba-v0.1-52b-smoke", 0, 32),
                ("whisper-base-smoke", 0, 32), ("qwen2-vl-2b-smoke", 0, 32),
                ("qwen2-7b", 1, 128))
ADAFACTOR_DONATE_CASES = DONATE_CASES + (("jamba-v0.1-52b", 2, 128),)


def donate_vs_functional(arch: str, layers: int, seq: int, opt_name: str = "adamw") -> None:
    """Three `opt_name` steps of make_train_step(donate=True) and of
    donate=False from the same weights on the card: every parameter, the
    optimizer's state (both moments, the count) and the metrics bitwise
    equal."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batches = [train_batch(cfg, TRAIN["batch"], seq, 10 + i, DEV) for i in range(3)]
    out = {}
    for donate in (False, True):
        params = init_params(cfg, torch.Generator(DEV).manual_seed(TRAIN["seed"]))
        opt = make_optimizer(opt_name, TRAIN["lr"])
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=False, donate=donate)
        metrics = []
        for b in batches:
            params, state, m = step(params, state, b)
            metrics.append(m)
        torch.cuda.synchronize()
        out[donate] = (params, state, metrics)
        del params, state
    (p0, s0, m0), (p1, s1, m1) = out[False], out[True]
    same = {"params": same_bits(p0, p1),
            **{k: same_bits(getattr(s0, k), getattr(s1, k)) for k in s0._fields},
            "metrics": same_bits(m0, m1)}
    name = {"adamw": "AdamW", "adafactor": "Adafactor"}[opt_name]
    line(f"train step {arch}" + (f" (full width, {layers} layer{'s' * (layers > 1)})"
                                 if layers else "")
         + f" B={TRAIN['batch']} seq={seq}, 3 {name} steps, donated vs functional on the "
         "card: " + "; ".join(f"{k} bitwise equal: {v}" for k, v in same.items())
         + f"; count={int(s1.count)} [{CARD}]")
    del out, p0, s0, p1, s1
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same.values()):
        raise AssertionError(f"train step {arch}: the donated {name} step differs from the "
                             "functional")


# One make_train_step with sgd on the card and on the CPU from the same
# weights: qwen2-7b at full width with 1 layer (batch 1, seq 32), and the
# four families' smoke configs (batch 2, seq 32).
CARD_VS_CPU = (("qwen2-7b", 1, 1), ("deepseek-v3-671b-smoke", 0, 2),
               ("jamba-v0.1-52b-smoke", 0, 2), ("whisper-base-smoke", 0, 2),
               ("qwen2-vl-2b-smoke", 0, 2))


def card_vs_cpu_step(arch: str, layers: int, batch_size: int) -> None:
    """One make_train_step with sgd, seq 32, from the same weights on the
    card and on the CPU: loss within 1e-2 absolute, grad norm within 2e-2
    relative.  For the full-width config also remat=True against
    remat=False on the card: bitwise equal, or the largest gap."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(TRAIN["seed"]))
    host = tree_map(lambda t: t.cpu(), params)
    batch = train_batch(cfg, batch_size, 32, 1, torch.device("cpu"))
    on_card = {k: v.to(DEV) for k, v in batch.items()}
    step = make_train_step(cfg, sgd(TRAIN["lr"]), remat=False)
    p_card, _, m_card = step(params, (), on_card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_host, _, m_host = step(host, (), batch)
    cpu_s = time.perf_counter() - t0
    loss, gn = float(m_card["loss"]), float(m_card["grad_norm"])
    loss_h, gn_h = float(m_host["loss"]), float(m_host["grad_norm"])
    moved = max(float((a.cpu().float() - c.float()).abs().max())
                for a, c in zip(tree_leaves(p_card), tree_leaves(p_host)))
    line(f"train step {arch}" + (f" (full width, {layers} layer, " if layers else " (")
         + f"sgd) B={batch_size} seq=32, card vs cpu on {CARD}: "
         f"params={param_count(params)} loss card={loss:.6f} cpu={loss_h:.6f} "
         f"|diff|={abs(loss - loss_h):.3e} (limit 1e-2); grad_norm card={gn:.6f} "
         f"cpu={gn_h:.6f} rel={abs(gn - gn_h) / gn_h:.3e} (limit 2e-2); largest gap in the "
         f"updated weights {moved:.3e}; cpu step {cpu_s:.1f}s "
         f"({torch.get_num_threads()} threads)")
    del p_host, host
    if not (abs(loss - loss_h) <= 1e-2 and abs(gn - gn_h) <= 2e-2 * gn_h):
        raise AssertionError(f"train step {arch}: the card is off the cpu")
    if not layers:
        return
    p_remat, _, m_remat = make_train_step(cfg, sgd(TRAIN["lr"]), remat=True)(params, (), on_card)
    gaps = [float((a.float() - c.float()).abs().max())
            for a, c in zip(tree_leaves(p_remat), tree_leaves(p_card))]
    same = (all(g == 0 for g in gaps) and torch.equal(m_remat["loss"], m_card["loss"])
            and torch.equal(m_remat["grad_norm"], m_card["grad_norm"]))
    line(f"  remat=True vs remat=False on the card: bitwise equal: {same}"
         + ("" if same else f"; largest gap in the updated weights {max(gaps):.3e}, loss "
            f"{abs(float(m_remat['loss']) - loss):.3e}, grad_norm "
            f"{abs(float(m_remat['grad_norm']) - gn):.3e}"))


def example_phase() -> None:
    """examples/torch_train_100m.py --steps 10 --ckpt-every 5 on the card
    into a temporary directory; its last checkpoint restores bitwise into
    the final parameters."""
    path = Path(__file__).resolve().parent / "examples" / "torch_train_100m.py"
    spec = importlib.util.spec_from_file_location("torch_train_100m", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ckpt_100m.npz"
        t0 = time.perf_counter()
        params = example.main(["--steps", "10", "--ckpt-every", "5", "--out", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, step = restore_checkpoint(str(out), params)
        same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                   for a, b in zip(tree_leaves(got), tree_leaves(params)))
        line(f"example torch_train_100m --steps 10 --ckpt-every 5 on {CARD}: wall_s={wall:.2f}; "
             f"checkpoint of {out.stat().st_size / 2**20:.1f} MiB at step {step} restores "
             f"bitwise: {same}")
    if not (same and step == 10):
        raise AssertionError("example checkpoint does not restore bitwise")


def train_phase() -> dict:
    """Phase 15; returns each run's launch counts and memory by run: the
    arch, or "<arch>/adafactor" for the dry run's step (ADAFACTOR_RUNS)."""
    laps = Laps()
    runs = {}
    for arch, layers, steps, seq in TRAIN_RUNS:
        runs[arch] = train_run(arch, layers, steps, seq)
        laps.lap(arch)
    for arch, layers, steps, seq, lr in ADAFACTOR_RUNS:
        runs[f"{arch}/adafactor"] = train_run(arch, layers, steps, seq, adafactor=True, lr=lr)
        laps.lap(f"{arch}/adafactor")
    gc.collect()
    torch.cuda.empty_cache()
    for case in DONATE_CASES:
        donate_vs_functional(*case)
    laps.lap("donated vs functional, AdamW")
    for case in ADAFACTOR_DONATE_CASES:
        donate_vs_functional(*case, opt_name="adafactor")
    laps.lap("donated vs functional, Adafactor")
    for case in CARD_VS_CPU:
        card_vs_cpu_step(*case)
        gc.collect()
        torch.cuda.empty_cache()
    laps.lap("card vs cpu")
    example_phase()
    laps.lap("example")
    laps.print("training phase")
    return runs


# The dry-run phase: the meta-device prediction (`repro_torch.launch`) of
# every served arch at its served depth and shape, and of both training
# runs, held to what phases 11-15 measured on the card.  Memory growth is
# held to the predicted bytes within 1% plus 64 MiB (the allocator's
# rounding, cuBLAS's workspace); parameter and cache bytes exactly.
GROWTH_RTOL, GROWTH_ATOL = 0.01, 64 * 2**20


def served_cfg(arch: str, layers: int):
    """The config phases 11-14 served, with K4's plain path (the meta run
    counts the attention's matmuls there; the parameter and cache shapes
    are the same) and K5 as served (its meta version gives the kernel's
    outputs, no Python loop over the tokens)."""
    return dataclasses.replace(get_config(arch), n_layers=layers, attn_impl="ref",
                               rwkv_wkv_impl="pallas")


def predict_serve(cfg) -> dict:
    """Meta prediction of one serve_loop (SERVE): parameter and cache
    bytes, the prefill's counted FLOPs, and the peak, the larger of the
    prefill's (arguments + temp) and the warm-up decode step's (parameters,
    the cache and its clone, the step's temp)."""
    b, s, new = SERVE["batch"], SERVE["prompt_len"], SERVE["new_tokens"]
    pre_shape = InputShape("serve", s, b, "prefill")
    dec_shape = InputShape("serve", s + new, b, "decode")
    params = tree_nbytes(tf_mod.param_shapes(cfg))
    cache = tree_nbytes(cache_specs(cfg, dec_shape))
    pre_args = tree_nbytes(dryrun.build_step(cfg, pre_shape, cache_headroom=new)[1])
    pre = dryrun.analyze(cfg, pre_shape, cache_headroom=new)
    dec = dryrun.analyze(cfg, dec_shape)
    peak = max(pre_args + pre["temp_size_in_bytes"],
               params + 2 * cache + dec["temp_size_in_bytes"])
    return dict(param_bytes=params, cache_bytes=cache, flops=pre["flops"],
                model_flops=model_flops(cfg, pre_shape)["forward"], peak=peak,
                roofline=analytic_cost(cfg, pre_shape, H100))


def predict_train(cfg, seq: int, opt_name: str = "adamw", remat: bool = False) -> dict:
    """Meta prediction of a training run's step (TRAIN at `seq`, donated;
    train_loop's: AdamW, remat off): parameter bytes, the steady state's
    arguments (parameters, the optimizer's state, the batch), the step's
    counted FLOPs and its peak."""
    shape = InputShape("train", seq, TRAIN["batch"], "train")
    kw = dict(opt=make_optimizer(opt_name, TRAIN["lr"]), remat=remat, donate=True)
    args = tree_nbytes(dryrun.build_step(cfg, shape, **kw)[1])
    step = dryrun.analyze(cfg, shape, **kw)
    return dict(param_bytes=tree_nbytes(tf_mod.param_shapes(cfg)), args=args,
                flops=step["flops"], model_flops=model_flops(cfg, shape)["train_total"],
                peak=args + step["temp_size_in_bytes"])


def within_growth(growth: int, predicted: int) -> bool:
    return abs(growth - predicted) <= GROWTH_RTOL * predicted + GROWTH_ATOL


def dryrun_phase(served: dict, train: dict) -> None:
    """Phase 16: no card run of its own.  For each served arch (served:
    {arch: serve_phase result}) the predicted parameter and cache bytes
    must equal the real tensors' and memory_allocated's growth over
    init_params must lie within GROWTH_RTOL + GROWTH_ATOL of the predicted
    parameter bytes; for each training run (train: {run: train_run
    result}) the parameter bytes exactly, and the growth over init_params
    and over one step (parameters, the optimizer's state, the batch)
    likewise; for the runs of PEAK_GATED max_memory_allocated at most the
    predicted peak plus that allowance.  Printed, not gated elsewhere: the
    predicted peak against max_memory_allocated,
    the counted FLOPs against model_flops, qwen2-7b's warm prefill against
    analytic_cost's bound, every line beside the card's name and power
    limit."""
    t0 = time.perf_counter()
    gib = 2**30
    for arch, res in served.items():
        mem = res["memory"]
        pred = predict_serve(served_cfg(arch, res["layers"]))
        ok = (pred["param_bytes"] == mem["param_bytes"]
              and pred["cache_bytes"] == mem["cache_bytes"]
              and within_growth(mem["init_growth"], pred["param_bytes"]))
        line(f"dry run vs card, serve {arch} ({res['layers']} layers, B={SERVE['batch']} "
             f"prompt={SERVE['prompt_len']} +{SERVE['new_tokens']}) on {CARD}: param bytes "
             f"predicted {pred['param_bytes']} real {mem['param_bytes']}; cache bytes predicted "
             f"{pred['cache_bytes']} real {mem['cache_bytes']}; memory_allocated growth over "
             f"init_params {mem['init_growth']} ({(mem['init_growth'] - pred['param_bytes']) / 2**20:+.1f}"
             f" MiB, limit 1% + 64 MiB); peak predicted {pred['peak'] / gib:.2f} GiB, "
             f"max_memory_allocated {mem['serve_peak'] / gib:.2f} GiB "
             f"({mem['serve_peak'] / pred['peak']:.3f}x); prefill counted flops "
             f"{pred['flops']:.4e} model_flops {pred['model_flops']:.4e} "
             f"({pred['flops'] / pred['model_flops']:.4f}x); pass={ok}")
        if not ok:
            raise AssertionError(f"dry run vs card, serve {arch}: prediction off the card")
        if arch == "qwen2-7b":
            roof, warm = pred["roofline"], res["warm"].prefill_s
            bound = max(roof["compute_s"], roof["memory_s"])
            line(f"  qwen2-7b prefill (warm run) {warm * 1e3:.3f} ms against analytic_cost "
                 f"(H100): compute_s {roof['compute_s'] * 1e3:.3f} ms, memory_s "
                 f"{roof['memory_s'] * 1e3:.3f} ms -> {bound / warm:.4f} of the bound; {CARD}")
    for run, res in train.items():
        mem = res["memory"]
        arch = mem["arch"]
        cfg = dataclasses.replace(get_config(arch), n_layers=mem["layers"])
        pred = predict_train(cfg, mem["seq"], mem["optimizer"], mem["remat"])
        ok = (pred["param_bytes"] == mem["param_bytes"]
              and within_growth(mem["init_growth"], pred["param_bytes"])
              and within_growth(mem["steady_growth"], pred["args"]))
        gated = run in PEAK_GATED
        under = mem["train_peak"] <= pred["peak"] * (1 + GROWTH_RTOL) + GROWTH_ATOL
        ok = ok and (under or not gated)
        line(f"dry run vs card, train {arch} ({mem['layers']} layers, B={TRAIN['batch']} "
             f"seq={mem['seq']}, {mem['optimizer']}, remat={mem['remat']}, donated) on "
             f"{CARD}: param bytes predicted "
             f"{pred['param_bytes']} real {mem['param_bytes']}; growth over init_params "
             f"{mem['init_growth']} ({(mem['init_growth'] - pred['param_bytes']) / 2**20:+.1f} "
             f"MiB); parameters + optimizer state + batch predicted {pred['args']}, growth over "
             f"init and one step {mem['steady_growth']} "
             f"({(mem['steady_growth'] - pred['args']) / 2**20:+.1f} MiB, limit 1% + 64 MiB); "
             f"peak predicted {pred['peak'] / gib:.2f} GiB, max_memory_allocated "
             f"{mem['train_peak'] / gib:.2f} GiB ({mem['train_peak'] / pred['peak']:.3f}x"
             + (f"; under the prediction + 1% + 64 MiB: {under}" if gated else "") + "); "
             f"counted flops {pred['flops']:.4e} model_flops train_total "
             f"{pred['model_flops']:.4e} ({pred['flops'] / pred['model_flops']:.4f}x), "
             f"{pred['model_flops'] / (mem['step_ms'] / 1e3) / 1e12:.2f} model TFLOP/s at the "
             f"warm step; pass={ok}")
        if not ok:
            raise AssertionError(f"dry run vs card, train {arch}: prediction off the card")
    wall = time.perf_counter() - t0
    line(f"dry-run phase wall_s={wall:.1f} (budget 30 s: {wall < 30}) on {CARD}")


# ---------------------------------------------------------------------------
# phase 18: across devices
# ---------------------------------------------------------------------------

# Shard counts of the emulated devices (`launch.mesh.emulate_devices`: n
# copies of cuda:0) for the Γ solve and for the groups.
GAMMA_SHARDS = (1, 2, 3)
GROUP_SHARDS = 2
# The meshed model: granite-moe-3b-a800m at full width, 16 of its 32
# layers (the dry run's donated AdamW step at this shape: 23.8 GiB, so the
# meshed and the unsharded copies fit side by side), batch 8 x seq 256.
MESH = dict(arch="granite-moe-3b-a800m", layers=16, batch=8, seq=256, lr=1e-3, steps=4,
            demo_lr=1e-4)
# One meshed step against the unsharded donated step: the whole batch's
# loss within 1e-5 relative, every parameter within 2.5 lr (AdamW's first
# step moves a parameter by about +-lr; a gradient whose sign differs
# between the two moves it 2 lr).  That bound holds for any gradient, so
# the backward pass is held by the gradients themselves: the meshed
# `make_grad_fn` against the unsharded one from the same weights on the
# same batch, each leaf within 1e-3 of its norm (||g - g_ref|| / ||g_ref||;
# a world of one sums in the unsharded order: 0 on the CPU, while one bf16
# rounding in another order is ~4e-3), and the step's gradient norm within
# 1e-5 relative.
MESH_LOSS_RTOL, MESH_PARAM_ATOL = 1e-5, 2.5 * MESH["lr"]
MESH_GRAD_RTOL, MESH_GNORM_RTOL = 1e-3, 1e-5


def gamma_shard_phase(pair_sets: dict) -> dict:
    """Γ row-sharded over 1, 2 and 3 emulated shards of cuda:0 on kernel K1
    and on the "mixed" backend: every field bitwise the unsharded solve,
    K1 launched once per shard ("mixed" never)."""
    cfg_w = WirelessConfig()
    out = {}
    for label, (beta, h2, e_max, wcfg) in pair_sets.items():
        for backend in (None, "mixed"):
            name = "K1" if backend is None else backend
            t0 = time.perf_counter()
            want = solve_pairs_fused(beta, h2, wcfg or cfg_w, e_max, backend=backend,
                                     device=DEV, shard=False)
            walls = {"unsharded": time.perf_counter() - t0}
            rows = int(want.feasible.sum())
            for n in GAMMA_SHARDS:
                polyblock_solve_fused.launches = 0
                t0 = time.perf_counter()
                with emulate_devices(n):
                    got = solve_pairs_fused(beta, h2, wcfg or cfg_w, e_max, backend=backend,
                                            device=DEV, shard=True)
                walls[n] = time.perf_counter() - t0
                k1 = polyblock_solve_fused.launches
                differ = [f for f in ("feasible", "iterations", "tau", "p", "time_s",
                                      "energy_j")
                          if not np.array_equal(getattr(got, f), getattr(want, f),
                                                equal_nan=True)]
                k1_want = n if backend is None else 0
                line(f"Γ {label} ({rows} feasible rows) backend={name} over {n} emulated "
                     f"shard(s) on cuda:0: bitwise equal to unsharded in every field: "
                     f"{not differ}" + (f" (differ: {differ})" if differ else "")
                     + f"; K1 launches={k1} (expected {k1_want}: one per shard)")
                if differ or k1 != k1_want:
                    raise AssertionError(f"Γ {label} {name} x{n}: sharded solve differs "
                                         f"({differ}) or K1 launched {k1} times")
                out.setdefault(label, {}).setdefault(name, {})[str(n)] = k1
            line(f"  Γ {label} backend={name} wall ms: " + ", ".join(
                f"{k}={v * 1e3:.3f}" for k, v in walls.items()) + f" [{CARD}]")
    return out


def group_shard_phase(batch: dict, hier_batch: dict) -> dict:
    """Phase 9's 16-cell `run_many` groups and 8-config `run_hier_many`
    groups again with shard=True over GROUP_SHARDS emulated shards of
    cuda:0 (scan and async): every member bitwise its unsharded group run
    of phase 9 (reused, not run again); K1 once per shard per Γ solve; K3
    launches as each shard's block of the group implies."""
    blocks = None
    out = {}
    for kind, runs, entry in (("batch", batch, run_many), ("hier batch", hier_batch,
                                                           run_hier_many)):
        for agg, res in runs.items():
            cfgs, refs = res["cfgs"], res["hists"]
            with emulate_devices(GROUP_SHARDS):
                hists, wall, launches, _ = run_on_card(cfgs, entry, engine="scan", shard=True)
            blocks = split_padded(len(cfgs), GROUP_SHARDS)
            differ = [f"{i}: {bitwise_diff(h, r, skip=())}" for i, (h, r) in
                      enumerate(zip(hists, refs)) if bitwise_diff(h, r, skip=())]
            if kind == "batch":
                worlds = 1
                k3_want = sum(cfgs[0].rounds if agg != "sync"
                              else group_k3_expected([hists[i] for i in blk]) for blk in blocks)
            else:
                worlds = len(HIER_BATCH_SEEDS)
                engine = "scan" if agg == "sync" else "async"
                shape = (cfgs[0].rounds, cfgs[0].n_cells, cfgs[0].devices_per_cell)
                k3_want = sum(hier_group_k3_expected(
                    cfgs[0], engine, [hists[i].tx_trace.reshape(shape) for i in blk])[0]
                    for blk in blocks)
            k1_want = worlds * GROUP_SHARDS
            name = f"{kind} {'scan' if agg == 'sync' else 'async'}"
            line(f"{name} shard=True over {GROUP_SHARDS} emulated shards of cuda:0: "
                 f"{len(cfgs)} members in blocks {[len(b) for b in blocks]}, wall_s={wall:.3f} "
                 f"(unsharded group {res['wall_s']:.3f}); K1 launches="
                 f"{launches['polyblock_fused']} (expected {k1_want}); K3 launches="
                 f"{launches['fedavg_agg']} (the blocks' traces imply {k3_want}) [{CARD}]")
            line(f"  {len(cfgs)} members vs phase 9's unsharded group on the card: bitwise "
                 f"equal in every field: {not differ}" + (f" (differ: {differ})" if differ
                                                          else ""))
            if differ:
                raise AssertionError(f"{name}: sharded members differ: {differ}")
            if (launches["polyblock_fused"], launches["fedavg_agg"]) != (k1_want, k3_want):
                raise AssertionError(f"{name}: K1/K3 launches differ from the expected counts")
            out[name] = launches
    return out


class CallCount:
    """Counts the calls of a module's function while in the block."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls = owner, name, 0

    def __enter__(self):
        self.inner = getattr(self.owner, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self.inner(*a, **kw)

        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)


def meshed_model_phase(t_all: float) -> dict:
    """The meshed model as a world of one (NCCL, a (1, 1) mesh, HashStore):
    granite-moe-3b-a800m at full width and MESH["layers"] layers.  One
    `multidevice_demo.run_rank` step (attn_shard="explicit": the
    expert-parallel MoE and `sharded_causal_attention`) against the port's
    unsharded donated step from the same weights on the same FL-weighted
    batch, then MESH["steps"] demo steps; the dry run's prediction of the
    step's peak beside max_memory_allocated; then the meshed gradient
    (`make_grad_fn` on the demo's sharding context) against the unsharded
    one, leaf by leaf."""
    cfg = dataclasses.replace(get_config(MESH["arch"]), n_layers=MESH["layers"])
    b, s, lr = MESH["batch"], MESH["seq"], MESH["lr"]
    shape = InputShape("mesh", s, b, "train")
    kw = dict(opt=adamw(lr), remat=False, donate=True)
    args = tree_nbytes(dryrun.build_step(cfg, shape, **kw)[1])
    peak = args + dryrun.analyze(cfg, shape, **kw)["temp_size_in_bytes"]
    init_world(0, 1, "nccl")
    try:
        p0 = init_params(cfg, torch.Generator(DEV).manual_seed(0))
        n_params = param_count(p0)
        for fn in COUNTERS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with CallCount(attention_mod, "sharded_causal_attention") as attn_calls, \
                CallCount(moe_mod, "_ep_moe") as moe_calls:
            t0 = time.perf_counter()
            one = run_rank(cfg, steps=1, batch=b, seq=s, lr=lr, params=tree_map(
                torch.clone, p0), device=DEV, log=False)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in COUNTERS.items()}
        meshed_peak = torch.cuda.max_memory_allocated() - base
        ex = {k: torch.as_tensor(v, device=DEV)
              for k, v in next(fl_batches(cfg, b, s, 0))[0].items()}
        ref = tree_map(torch.clone, p0)
        opt = adamw(lr)
        ref, _, m = make_train_step(cfg, opt, remat=False, donate=True)(ref, opt.init(ref), ex)
        loss_rel = abs(one["losses"][0] - float(m["loss"])) / abs(float(m["loss"]))
        gnorm_rel = abs(one["grad_norms"][0] - float(m["grad_norm"])) / float(m["grad_norm"])
        diffs = [(a.float() - r.float()).abs() for a, r in
                 zip(tree_leaves(one["params"]), tree_leaves(ref))]
        max_diff = max(float(d.max()) for d in diffs)
        moved = sum(int((d > 0).sum()) for d in diffs)
        n_layers = cfg.n_layers
        line(f"meshed model {cfg.name} (full width, {n_layers} of 32 layers, params="
             f"{n_params}) as a world of one (NCCL, (1, 1) mesh, attn_shard=explicit), "
             f"batch {b} x seq {s}, AdamW lr {lr}: one step {step_s:.3f}s (its first, "
             f"with the mesh and NCCL set-up); sharded_causal_attention calls="
             f"{attn_calls.calls} (expected {n_layers}), expert-parallel MoE calls="
             f"{moe_calls.calls} (expected {n_layers}); kernel launches on the meshed "
             f"training path: " + " ".join(f"{k}={v}" for k, v in launches.items())
             + f" [{CARD}]")
        line(f"  one meshed step vs the unsharded donated step from the same weights: loss "
             f"{one['losses'][0]:.6f} vs {float(m['loss']):.6f} (rel {loss_rel:.3e}, limit "
             f"{MESH_LOSS_RTOL:g}); parameters max |diff|={max_diff:.3e} (limit "
             f"{MESH_PARAM_ATOL:g}), elements that differ at all: {moved} of {n_params}")
        line(f"  dry run's predicted peak of the donated AdamW step at this shape "
             f"{peak / 2**30:.2f} GiB; the meshed step's max_memory_allocated growth "
             f"{meshed_peak / 2**30:.2f} GiB [{CARD}]")
        del one, ref, diffs, opt, m
        gc.collect()
        torch.cuda.empty_cache()
        ctx = demo_ctx(1, 1, b, s, "explicit", "cuda")
        blocks = shard_tree(p0, param_specs(cfg, ctx.mesh, 1), ctx.mesh)
        g_mesh, m_mesh = make_grad_fn(cfg, remat=False, ctx=ctx)(blocks, ex)
        del blocks
        g_ref, m_ref = make_grad_fn(cfg, remat=False)(p0, ex)
        gaps = leaf_gaps(g_mesh, g_ref)
        worst = max(range(len(gaps)), key=gaps.__getitem__)
        worst_path = leaves_with_path(p0)[worst][0]
        grad_gnorm_rel = abs(float(m_mesh["grad_norm"]) - float(m_ref["grad_norm"])) / float(
            m_ref["grad_norm"])
        line(f"  gradients, meshed make_grad_fn vs unsharded from the same weights on the same "
             f"batch: worst leaf ||g - g_ref|| / ||g_ref||={gaps[worst]:.3e} at {worst_path} "
             f"(limit {MESH_GRAD_RTOL:g}), leaves that differ at all: "
             f"{sum(gap > 0 for gap in gaps)} of {len(gaps)}; grad norm "
             f"{float(m_mesh['grad_norm']):.6f} vs {float(m_ref['grad_norm']):.6f} (rel "
             f"{grad_gnorm_rel:.3e}); the step's grad "
             f"norm rel {gnorm_rel:.3e} (limit {MESH_GNORM_RTOL:g} each)")
        del g_mesh, g_ref, m_mesh, m_ref
        if loss_rel > MESH_LOSS_RTOL or max_diff > MESH_PARAM_ATOL:
            raise AssertionError("meshed model: one step differs from the unsharded step "
                                 "beyond the limits")
        if gaps[worst] > MESH_GRAD_RTOL or max(gnorm_rel, grad_gnorm_rel) > MESH_GNORM_RTOL:
            raise AssertionError("meshed model: the meshed gradient differs from the unsharded "
                                 "one beyond the limits")
        if attn_calls.calls != n_layers or moe_calls.calls != n_layers:
            raise AssertionError("meshed model: the step did not run the sharded attention "
                                 "and the expert-parallel MoE on every layer")
        if any(launches.values()):
            raise AssertionError("meshed model: a kernel launched on the meshed training "
                                 "path (K4 stays off a mesh, K1-K3 and K5 are not on it)")
        meshed_adafactor(cfg, ctx, p0, ex)
        del p0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        demo = run_rank(cfg, steps=MESH["steps"], batch=b, seq=s, lr=MESH["demo_lr"],
                        device=DEV, log=False)
        torch.cuda.synchronize()
        demo_s = time.perf_counter() - t0
        losses = demo["losses"]
        line(f"  multidevice_demo.run_rank, {MESH['steps']} FL-weighted meshed steps from "
             f"seed 0 at lr {MESH['demo_lr']:g} (not gated): losses "
             + " ".join(f"{x:.4f}" for x in losses)
             + f"; wall_s={demo_s:.3f} (init_params included) [{CARD}]")
        if not all(math.isfinite(x) for x in losses + demo["grad_norms"]):
            raise AssertionError("meshed model: a loss or gradient norm is not finite")
        del demo
        gc.collect()
        torch.cuda.empty_cache()
        phase_mark(19, t_all)
        t19 = time.perf_counter()
        serve = meshed_serve_phase(cfg)
        rwkv_cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=MESH_RWKV_LAYERS,
                                       rwkv_wkv_impl="pallas")
        serve_rwkv = meshed_serve_phase(
            rwkv_cfg, {"rwkv6_wkv": MESH_RWKV_LAYERS * (1 + MESH_SERVE["new"])})
        line(f"phase 19 (a) wall_s={time.perf_counter() - t19:.1f} [{CARD}]")
    finally:
        dist.destroy_process_group()
    return dict(loss_rel=loss_rel, max_diff=max_diff, grad_gap=gaps[worst], launches=launches,
                serve=serve, serve_rwkv=serve_rwkv)


def meshed_adafactor(cfg, ctx, p0, ex) -> None:
    """Phase 15 (d), in phase 18's world of one: one meshed Adafactor step
    (`make_train_step(ctx=)`, the state from `mesh_optimizer`: the sharded
    form) donated and functional from copies of the same weights on the
    same batch: every parameter block, both moments, the count and the
    metrics bitwise equal, no kernel launched."""
    opt = adafactor(MESH["lr"])
    out = {}
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for donate in (False, True):
        blocks = shard_tree(tree_map(torch.clone, p0), param_specs(cfg, ctx.mesh, 1), ctx.mesh)
        state = mesh_optimizer(cfg, opt, ctx).init(blocks)
        step = make_train_step(cfg, opt, remat=False, donate=donate, ctx=ctx)
        out[donate] = step(blocks, state, ex)
        torch.cuda.synchronize()
        del blocks, state
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    (p_f, s_f, m_f), (p_d, s_d, m_d) = out[False], out[True]
    same = {"params": same_bits(p_f, p_d),
            **{k: same_bits(getattr(s_f, k), getattr(s_d, k)) for k in s_f._fields},
            "metrics": same_bits(m_f, m_d)}
    line(f"  one meshed Adafactor step (sharded form, (1, 1) mesh) of {cfg.name} "
         f"({cfg.n_layers} layers), donated vs functional from the same weights: "
         + "; ".join(f"{k} bitwise equal: {v}" for k, v in same.items())
         + f"; loss {float(m_d['loss']):.6f}; kernel launches "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + f"; wall_s={wall:.2f} (both steps) [{CARD}]")
    del out, p_f, s_f, p_d, s_d
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same.values()) or any(launches.values()):
        raise AssertionError("meshed model: the donated Adafactor step differs from the "
                             "functional one, or a kernel launched")


# Phase 19 (a): granite at phase 18's width and depth, then rwkv6-7b at
# full width and MESH_RWKV_LAYERS layers through K5 ("pallas"), a prompt of
# MESH_SERVE["prompt"] tokens for MESH_SERVE["batch"] rows, then
# MESH_SERVE["new"] greedy decode steps.
MESH_SERVE = dict(batch=4, prompt=256, new=4, seed=7, timed_steps=8, passes=3)
MESH_RWKV_LAYERS = 4


def meshed_serve_phase(cfg, expect: dict | None = None) -> dict:
    """Phase 19 (a), inside phase 18's world-of-one NCCL group: the meshed
    serving steps on a (1, 1) mesh (this rank's blocks, which the layers
    compute with as held, the cache in `cache_shardings`' layout read
    through the flash-decoding combine) against the unmeshed steps from
    the same weights: tokens, logits and every cache leaf after the
    prefill and after each greedy step bitwise; then each path's decode
    timed over MESH_SERVE["passes"] passes of MESH_SERVE["timed_steps"]
    steps in turns after a warm-up pass each (`tp_timing`).  The meshed
    run's kernel launches (every counter set to 0 just before it, read
    just after) equal `expect` ({kernel: launches}; every other kernel 0)."""
    b, prompt, new = MESH_SERVE["batch"], MESH_SERVE["prompt"], MESH_SERVE["new"]
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    gen = torch.Generator(DEV).manual_seed(MESH_SERVE["seed"])
    tokens = torch.randint(0, cfg.vocab, (b, prompt), generator=gen, device=DEV)
    ctx = ShardCtx(mesh=smoke_mesh(1, 1, "cuda"), attn_shard="explicit")
    blocks = shard_tree(params, param_specs(cfg, ctx.mesh, 1), ctx.mesh)

    def serve(weights, step_ctx) -> list:
        """[(token, logits, cache copy) after the prefill and each step]."""
        prefill = make_prefill_step(cfg, cache_headroom=new, ctx=step_ctx)
        step = make_serve_step(cfg, ctx=step_ctx)
        with torch.no_grad():
            logits, cache = prefill(weights, {"tokens": tokens})
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out = [(tok, logits, tf_mod.clone_cache(cache))]
            for i in range(new):
                tok, logits, cache = step(weights, {"token": tok,
                                                    "pos": torch.tensor(prompt + i, device=DEV)},
                                          cache)
                out.append((tok, logits, tf_mod.clone_cache(cache)))
        return out

    for fn in COUNTERS.values():
        fn.launches = 0
    meshed = serve(blocks, ctx)
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    plain = serve(params, None)
    times = tp_timing().summary(tp_timing().decode_passes(
        cfg, params, blocks, ctx, tokens, MESH_SERVE["timed_steps"], MESH_SERVE["passes"]))
    meshed_ms, plain_ms = times["meshed"]["median"], times["unmeshed"]["median"]
    equal = []
    for (t1, l1, c1), (t2, l2, c2) in zip(meshed, plain):
        leaves = [(a, c) for (_, a), (_, c) in zip(leaves_with_path(c1), leaves_with_path(c2))]
        equal.append(torch.equal(t1, t2) and torch.equal(l1, l2)
                     and len(leaves) == len(leaves_with_path(c2))
                     and all(a.shape == c.shape and torch.equal(a, c) for a, c in leaves))
    want = {name: (expect or {}).get(name, 0) for name in launches}
    line(f"phase 19 (a) meshed serving {cfg.name} (full width, {cfg.n_layers} layers) on a "
         f"(1, 1) mesh in phase 18's NCCL group: prefill {b} x {prompt} + {new} greedy steps, "
         f"tokens, logits and every cache leaf bitwise the unmeshed steps after the prefill and "
         f"each step: {all(equal)} ({sum(equal)} of {len(equal)}); decode ms/step over "
         f"{MESH_SERVE['passes']} passes of {MESH_SERVE['timed_steps']} steps after a warm-up "
         f"pass each (examples/torch_tp_timing.py): meshed median {meshed_ms:.3f} "
         f"[{times['meshed']['min']:.3f}, {times['meshed']['max']:.3f}], unmeshed median "
         f"{plain_ms:.3f} [{times['unmeshed']['min']:.3f}, {times['unmeshed']['max']:.3f}] "
         f"(ratio of medians {meshed_ms / plain_ms:.3f}); kernel "
         f"launches on the meshed serving path: "
         + " ".join(f"{k}={v}" for k, v in launches.items())
         + " (expected " + (" ".join(f"{k}={v}" for k, v in want.items() if v) or "none")
         + ")"
         + f" [{CARD}]")
    if not all(equal):
        raise AssertionError("phase 19 (a): the meshed serving steps differ from the unmeshed "
                             "ones on a (1, 1) mesh")
    if launches != want:
        raise AssertionError(f"phase 19 (a): kernel launches on the meshed serving path "
                             f"{launches}, expected {want}")
    del params, blocks, meshed, plain
    gc.collect()
    torch.cuda.empty_cache()
    return dict(bitwise=all(equal), meshed_ms=meshed_ms, plain_ms=plain_ms, launches=launches,
                times=times)


def tp_timing():
    """examples/torch_tp_timing.py as a module (its decode timing)."""
    if "torch_tp_timing" not in sys.modules:
        path = Path(__file__).resolve().parent / "examples" / "torch_tp_timing.py"
        spec = importlib.util.spec_from_file_location("torch_tp_timing", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["torch_tp_timing"] = mod
    return sys.modules["torch_tp_timing"]


class MeshDryrun:
    """Phase 19 (b): the dry run on the production mesh in a subprocess
    (`python -m repro_torch.launch.dryrun`, 16x16, meta tensors on a fake
    256-rank group; it touches no card).  Started on entering the block, so
    it runs on the host's other cores beside phase 18; `finish` waits for
    it, prints its lines and gates `fits`: 80 GiB and this card's total
    memory.  Leaving the block kills it if it still runs."""

    def __enter__(self):
        src = str(Path(__file__).resolve().parent / "src")
        env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
        self.tmp = tempfile.TemporaryDirectory(prefix="mesh_dryrun_")
        self.out = Path(self.tmp.name) / "dry.json"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-7b", "--shape",
             "train_4k", "--detail", "--json", str(self.out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=self.tmp.name)
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self.tmp.cleanup()

    def finish(self) -> dict:
        t_wait = time.perf_counter()
        stdout, stderr = self.proc.communicate(timeout=600)
        waited = time.perf_counter() - t_wait
        wall = time.perf_counter() - self.t0
        for ln in stdout.splitlines():
            line("  dryrun: " + ln)
        if self.proc.returncode != 0:
            line(stderr[-4000:])
            raise AssertionError(f"phase 19 (b): the mesh dry run exited {self.proc.returncode}")
        res = json.loads(self.out.read_text())["results"][0]
        total = torch.cuda.get_device_properties(0).total_memory
        need = res["argument_size_in_bytes"] + res["temp_size_in_bytes"]
        coll = res["collectives"]
        line(f"phase 19 (b) dry run on the production mesh (meta, fake group of "
             f"{res['devices']} ranks, mesh {res['mesh']}, a subprocess beside phase 18: "
             f"wall_s={wall:.1f}, waited for after it {waited:.1f}): qwen2-7b train_4k per device "
             f"args {res['argument_size_in_bytes'] / 2**30:.2f} GiB + temp "
             f"{res['temp_size_in_bytes'] / 2**30:.2f} GiB = {need / 2**30:.2f} GiB; collectives "
             + " ".join(f"{k}={coll[k] / 2**20:.1f}MiB" for k in
                        ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "total"))
             + f" count={coll['count']}; fits 80 GiB: {res['fits']}; this card's total_memory "
             f"{total / 2**30:.2f} GiB: fits={need <= total} [{CARD}]")
        if not (res["fits"] and need <= total):
            raise AssertionError("phase 19 (b): qwen2-7b train_4k does not fit one card per "
                                 "device on the production mesh")
        return dict(res=res, total_memory=total, wall_s=wall, waited_s=waited)


def shard_phase(pair_sets: dict, batch: dict, hier_batch: dict, t_all: float) -> dict:
    """Phase 18: the simulation's shard= (Γ and the groups) and the meshed
    model, each part's wall time printed; phase 19 (a) runs at its end, in
    its NCCL group."""
    t0 = time.perf_counter()
    gamma = gamma_shard_phase(pair_sets)
    t1 = time.perf_counter()
    groups = group_shard_phase(batch, hier_batch)
    t2 = time.perf_counter()
    model = meshed_model_phase(t_all)
    t3 = time.perf_counter()
    line(f"shard phase wall_s: gamma={t1 - t0:.1f} groups={t2 - t1:.1f} "
         f"meshed_model={t3 - t2:.1f} (sum {t3 - t0:.1f}) [{CARD}]")
    return dict(gamma=gamma, groups=groups, model=model)


def ptxas_lines(lib: str, kernel: str) -> list[str]:
    """ptxas's report (-Xptxas=-v: registers, static shared memory, spills)
    for every entry of library `lib` whose name contains `kernel`."""
    out, keep = [], False
    for ln in _build.build_info(lib)["log"].splitlines():
        if "Compiling entry" in ln:
            keep = kernel in ln
            name = ln.split("'")[1] if "'" in ln else ln
        elif keep and ("Used" in ln or "spill" in ln):
            out.append(f"{name}: {ln.strip()}")
    return out or [f"{kernel}: no ptxas report in the build log of {lib}"]


def bitwise_diff(a, b, skip=("commit_trace", "async_trace")) -> list[str]:
    """The fields of two histories, but the wall times and `skip`, that
    differ in any bit."""
    diff = []
    for f in dataclasses.fields(a):
        if f.name in ("wall_s", "plan_wall_s") + tuple(skip):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            same = x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        else:
            same = np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        if not same:
            diff.append(f.name)
    return diff


def assert_bitwise(a, b, what: str) -> None:
    """Every per-round field of two histories equal to the bit."""
    diff = bitwise_diff(a, b)
    line(f"{what}: bitwise equal in every field: {not diff}" + (f" (differ: {diff})" if diff else ""))
    if diff:
        raise AssertionError(f"{what}: fields differ: {diff}")


def main() -> None:
    t_all = time.perf_counter()
    # ---- 1. card identity -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    global CARD
    CARD = smi.splitlines()[0]
    line(CARD)                           # the card's name and power limit
    line(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
         f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
         "torch.backends.cudnn.allow_tf32=False")

    # ---- 2. kernel build --------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        for fut in [pool.submit(_build.load, lib) for lib in _build.LIBRARIES]:
            fut.result()
    line(f"build: {len(_build.LIBRARIES)} libraries loaded in {time.perf_counter() - t0:.2f}s")
    for lib in _build.LIBRARIES:
        info = _build.build_info(lib)
        line(f"  {lib}: {info['library']} nvcc_s={info['seconds']:.2f} "
             f"flags: {' '.join(_build.nvcc_flags(lib))}")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                line("  ptxas: " + ln.strip())

    cfg_w = WirelessConfig()
    to = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=DEV)

    # ---- 3. K2 --------------------------------------------------------------
    phase_mark(3, t_all)
    n2 = 131072
    beta, h2 = feasible_draw(n2, seed=11, cfg=cfg_w)
    rng = np.random.default_rng(12)
    v = rng.uniform(0.05, 1, (2 * n2, 2))
    beta2, h22 = np.concatenate([beta, beta]), np.concatenate([h2, h2])
    check_k2(to(v), to(beta2), to(h22), to(np.full(2 * n2, cfg_w.e_max_j)), cfg_w,
             "2x131072 vertices", reps=20)
    step_cfg = SimConfig(rounds=10)
    mb, mh, me, mcfg = main_path_pairs(step_cfg)
    k2_main = check_k2(*children_of_first_iteration(to(mb), to(mh), to(me), mcfg), mcfg,
                       "main-path shape (first children call, rounds=10)", reps=50)
    k2_sass_bound(k2_main[torch.float64]["evals"])

    # ---- 4. K1 --------------------------------------------------------------
    phase_mark(4, t_all)
    n_dev, k_sub = 32768, 4
    rng = np.random.default_rng(21)
    h2_mat = rng.exponential(size=(k_sub, n_dev)) * 3
    beta_mat = np.broadcast_to(rng.integers(5, 60, n_dev).astype(np.float64), h2_mat.shape)
    keep = ~is_infeasible(h2_mat, cfg_w, np.full(h2_mat.shape, cfg_w.e_max_j))
    line(f"K1 batch: {n_dev} devices x {k_sub} sub-channels, "
         f"{int(keep.sum())} Prop-1 feasible pairs")
    check_k1(to(beta_mat[keep]), to(h2_mat[keep]),
             to(np.full(int(keep.sum()), cfg_w.e_max_j)), cfg_w,
             f"{n_dev}x{k_sub}", reps=10, bulk_iters=9)
    big_children = children_of_first_iteration(
        to(beta_mat[keep]), to(h2_mat[keep]), to(np.full(int(keep.sum()), cfg_w.e_max_j)),
        cfg_w)
    sweep_k2(*big_children, cfg_w, f"first children call of the {n_dev}x{k_sub} pairs",
             (1024, 4096, 8192, 16384, 32768, 65536, big_children[0].shape[0]), reps=20)
    main_cfg = SimConfig(rounds=30)
    mb, mh, me, mcfg = main_path_pairs(main_cfg)
    k1_main = check_k1(to(mb), to(mh), to(me), mcfg, "main-path shape (rounds=30)",
                       reps=50)

    # ---- 5. K3 ---------------------------------------------------------------
    phase_mark(5, t_all)
    gen = torch.Generator(DEV).manual_seed(5)
    leaves = [torch.randn((4,) + p.shape, generator=gen, device=DEV).reshape(4, -1)
              for p in get_small_model(main_cfg.dataset).parameters()]
    k3_main = check_k3(leaves, "main-path shape (mnist MLP leaves, one aggregation)",
                       reps=50, plain_reps=3)
    big = torch.randn(16, 1 << 25, generator=gen, device=DEV)
    check_k3([big], "K=16 N=2^25", reps=20, plain_reps=2)
    del big
    mlp_shapes = [tuple(p.shape) for p in get_small_model(main_cfg.dataset).parameters()]
    k3_cells = {b: check_k3_cells(mlp_shapes, b, reps=50) for b in (1, 16, 32)}

    # ---- 6. K4 and K5 -----------------------------------------------------------
    phase_mark(6, t_all)
    qwen, rwkv = get_config("qwen2-7b"), get_config("rwkv6-7b")
    fa_lib, wkv_lib = _build.load("flash_attention"), _build.load("rwkv6_wkv")
    for fn, opcodes in _build.sass_opcodes("flash_attention", ("HGMMA", "HMMA")).items():
        if "flash_fwd_bf16_wgmma" in fn:
            line(f"K4 bf16 entry SASS, {fn}: tensor-core instructions "
                 + " ".join(f"{op}={n}" for op, n in opcodes.items()))
    line("K4 bf16 entry: dynamic shared memory "
         + ", ".join(f"D={d}: {fa_lib.flash_attention_bf16_smem_bytes(d)} bytes"
                     for d in (64, 80, 128)))
    for ln in ptxas_lines("flash_attention", "flash_fwd_bf16_wgmma"):
        line("  ptxas: " + ln)
    line(f"K5 wkv6_f32: {wkv_lib.wkv6_threads_per_block(rwkv.rwkv_head_size)} threads per block "
         f"at hs={rwkv.rwkv_head_size}")
    for ln in ptxas_lines("rwkv6_wkv", "wkv6_kernel"):
        line("  ptxas: " + ln)
    b, s = SERVE["batch"], SERVE["prompt_len"]
    attn_shape = (b, s, s, qwen.n_heads, qwen.n_kv_heads, qwen.head_dim, 0)
    k4_main = check_k4(*attn_shape, torch.bfloat16, "main-path shape (qwen2-7b prefill)",
                       reps=20)
    check_k4(*attn_shape, torch.float32, "main-path shape (qwen2-7b prefill)", reps=10)
    for dtype in (torch.bfloat16, torch.float32):
        check_k4(b, 384, s, qwen.n_heads, qwen.n_kv_heads, qwen.head_dim, 128, dtype,
                 "Sq < Sk, window 128", reps=10)
    # D = 80 at stablelm-3b's prefill shape (32 heads, MHA), on CARD.
    slm = get_config("stablelm-3b")
    slm_shape = (b, s, s, slm.n_heads, slm.n_kv_heads, slm.head_dim, 0)
    k4_d80 = check_k4(*slm_shape, torch.bfloat16, f"D=80 (stablelm-3b prefill) on {CARD}",
                      reps=20)
    check_k4(*slm_shape, torch.float32, "D=80 (stablelm-3b prefill)", reps=10)
    for dtype in (torch.bfloat16, torch.float32):
        check_k4(b, 384, s, slm.n_heads, slm.n_kv_heads, slm.head_dim, 128, dtype,
                 "D=80, Sq < Sk, window 128", reps=10)
    f80 = 4 * b * slm.n_heads * slm.head_dim * attn_pairs(s, s, 0)
    f128 = 4 * b * qwen.n_heads * qwen.head_dim * attn_pairs(s, s, 0)
    line(f"K4 bf16 per FLOP: D=80 {f80 / k4_d80['ms'] / 1e9:.2f} TFLOP/s against D=128 "
         f"{f128 / k4_main['ms'] / 1e9:.2f} (time per FLOP at D=80: "
         f"{(k4_d80['ms'] / f80) / (k4_main['ms'] / f128):.2f}x D=128's)")
    wkv_shape = (b, rwkv.n_rwkv_heads, rwkv.rwkv_head_size)
    k5_main = check_k5(b, s, *wkv_shape[1:], "main-path prefill shape (rwkv6-7b)", reps=20)
    # The meshed path's head block: rank r of `model` 16 runs 4 of the 64 heads.
    k5_heads = check_k5(b, s, rwkv.n_rwkv_heads // 16, rwkv.rwkv_head_size,
                        "head block at model 16 (rwkv6-7b, 4 of 64 heads a rank)", reps=20)
    k5_decode = check_k5(b, 1, *wkv_shape[1:], "main-path decode shape (rwkv6-7b, T=1)",
                         reps=200)

    # ---- 7. the simulation's main paths ---------------------------------------
    phase_mark(7, t_all)
    loop, loop_launches = drive(main_cfg, ("polyblock_fused", "fedavg_agg"))
    step, step_launches = drive(step_cfg, ("polyblock_project", "fedavg_agg"), ra_solver="step")
    scan, scan_launches = drive(main_cfg, ("polyblock_fused", "fedavg_agg"), engine="scan")
    asy, async_launches = drive(dataclasses.replace(main_cfg, aggregation="async"),
                                ("polyblock_fused", "fedavg_agg"), engine="async")
    full, _, _, _ = run_on_card(dataclasses.replace(main_cfg, aggregation="async_full"),
                                engine="async")
    assert_bitwise(full, scan, "async_full vs scan on the card")
    profile_run(main_cfg)
    profile_run(step_cfg, focus=("project_",), ra_solver="step")
    profile_run(main_cfg, engine="scan")
    count_syncs(main_cfg)
    count_syncs(main_cfg, engine="scan")
    count_syncs(dataclasses.replace(main_cfg, aggregation="async"), engine="async")
    # One K3 launch per aggregation: every round with a transmission (loop,
    # scan), every commit event (async: one per round).
    k3 = {name: (c["fedavg_agg"], rounds if name == "async" else int(h.tx_trace.any(1).sum()))
          for name, c, h, rounds in (("loop", loop_launches, loop, main_cfg.rounds),
                                     ("loop_step", step_launches, step, step_cfg.rounds),
                                     ("scan", scan_launches, scan, main_cfg.rounds),
                                     ("async", async_launches, asy, main_cfg.rounds))}
    line("K3 launches per run_simulation: " + " ".join(f"{k}={v[0]}" for k, v in k3.items())
         + " (aggregations: " + " ".join(f"{k}={v[1]}" for k, v in k3.items()) + ")")
    if any(n != want for n, want in k3.values()):
        raise AssertionError("K3 did not launch once per aggregation")
    if any(c["polyblock_fused"] != 1 for c in (loop_launches, scan_launches, async_launches)):
        raise AssertionError("K1 did not launch exactly once per run")
    if step_launches["polyblock_project"] != K2_STEP_LAUNCHES:
        raise AssertionError(f"K2 launched {step_launches['polyblock_project']} times on the "
                             f"step run, expected {K2_STEP_LAUNCHES}")

    # ---- 8. the hierarchy's main paths ----------------------------------------
    phase_mark(8, t_all)
    k1_at = {}                           # K1's bound at the later paths' pairs
    hier_cfg = HierSimConfig(rounds=30, seed=0)
    fused = ("polyblock_fused", "fedavg_agg")
    h_loop, hl_launches = drive_hier(hier_cfg, "loop", fused)
    h_scan, hs_launches = drive_hier(hier_cfg, "scan", fused)
    h_async, ha_launches = drive_hier(
        dataclasses.replace(hier_cfg, aggregation="async", global_aggregation="async"),
        "async", fused)
    h_full = run_on_card(dataclasses.replace(hier_cfg, aggregation="async_full",
                                             global_aggregation="async_full"),
                         hier_sim, engine="async")[0]
    assert_bitwise(h_full["hist"], h_scan["hist"],
                   "hier async_full at both tiers vs scan on the card")
    _, hstep_launches = drive_hier(dataclasses.replace(hier_cfg, rounds=10), "scan",
                                   ("polyblock_project", "fedavg_agg"), ra_solver="step")
    _, h3_launches = drive_hier(dataclasses.replace(hier_cfg, n_cells=3,
                                                    scenario="corr_fading",
                                                    cell_coupling=0.5), "scan", fused)
    profile_run(hier_cfg, focus=("solve_", "agg_leaves"), run=hier_sim, engine="scan")
    count_syncs(hier_cfg, run=hier_sim, engine="scan")
    hb, hh, he, hcfg = hier_pairs(hier_cfg)
    k1_at["hierarchy"] = k1_bound("the hierarchy's pairs (HierSimConfig(rounds=30), both cells)",
                                  to(hb), to(hh), to(he), hcfg)
    line("K3 launches per hierarchy run: " + " ".join(
        f"{k}={v['fedavg_agg']}" for k, v in (("loop", hl_launches), ("scan", hs_launches),
                                              ("async", ha_launches),
                                              ("scan_step", hstep_launches),
                                              ("scan_3_cells", h3_launches))))

    # ---- 9. a run_many group as one batch on a cell axis ---------------------
    phase_mark(9, t_all)
    t_batch = time.perf_counter()
    batch = {agg: batch_phase(agg) for agg in ("sync", "async")}
    t_hier = time.perf_counter()
    hier_batch = {agg: hier_batch_phase(agg) for agg in ("sync", "async")}
    line(f"hier batch wall_s={time.perf_counter() - t_hier:.1f}; batch phase "
         f"wall_s={time.perf_counter() - t_batch:.1f} [{CARD}]")

    # ---- 10. the sweep harness and the sustained service ----------------------
    phase_mark(10, t_all)
    line(f"sweep and service on {CARD}")
    t_sweep = time.perf_counter()
    sweep = sweep_phase()
    t_service = time.perf_counter()
    service = service_phase()
    line(f"sweep phase wall_s={t_service - t_sweep:.1f}; service phase "
         f"wall_s={time.perf_counter() - t_service:.1f} [{CARD}]")
    sb, sh, se, scfg = service["pairs"]
    k1_at["service_segment"] = k1_bound("the service's first segment (100 events x 16 x 64)",
                                        to(sb), to(sh), to(se), scfg)

    # ---- 10b. the Γ solver's projection backends -------------------------------
    phase_mark("10b", t_all)
    t_ra = time.perf_counter()
    ra = ra_backend_phase(main_cfg, step_cfg, hier_cfg,
                          {"main": (mb, mh, me, mcfg), "service": service["pairs"]})
    line(f"ra_backend phase wall_s={time.perf_counter() - t_ra:.1f} [{CARD}]")

    # ---- 11. the serving paths -----------------------------------------------
    phase_mark(11, t_all)
    n_new = SERVE["new_tokens"]
    qwen_serve = serve_phase("qwen2-7b", "flash_attention", qwen.n_layers)
    rwkv_serve = serve_phase("rwkv6-7b", "rwkv6_wkv", rwkv.n_layers * (1 + n_new + 1))
    line(f"K5 per launch on the card: prefill {k5_main['ms']:.4f} ms, decode "
         f"{k5_decode['ms']:.4f} ms")

    # ---- 12. four more archs of the zoo ---------------------------------------
    phase_mark(12, t_all)
    zoo = zoo_phase()

    # ---- 13. MLA and Mamba: deepseek-v3-671b and jamba-v0.1-52b -------------------
    phase_mark(13, t_all)
    mla_mamba = mla_mamba_phase()

    # ---- 14. the audio and VLM families: whisper-base and qwen2-vl-2b -----------
    phase_mark(14, t_all)
    audio_vlm = audio_vlm_phase()

    # ---- 15. the training path ------------------------------------------------
    phase_mark(15, t_all)
    train = train_phase()

    # ---- 16. the dry run against the card ------------------------------------
    phase_mark(16, t_all)
    dryrun_phase({"qwen2-7b": qwen_serve, "rwkv6-7b": rwkv_serve, **zoo, **mla_mamba,
                  **audio_vlm["serve"]}, train)

    # ---- 18. across devices (runs before the kernel list, which stays last) ----
    phase_mark(18, t_all)
    rng = np.random.default_rng(17)
    h2_77 = rng.exponential(size=(3, 4, 77)) * 3
    beta_77 = np.broadcast_to(rng.integers(5, 60, 77).astype(np.float64), h2_77.shape)
    # 19 (b), the dry run on the production mesh, runs in a subprocess beside
    # phase 18 (19 (a) runs in phase 18's NCCL group).
    with MeshDryrun() as mesh_dry:
        shard = shard_phase({"77x(3,4)": (beta_77, h2_77, None, None),
                             "main path": (mb, mh, me, mcfg),
                             "service segment": service["pairs"]},
                            batch, hier_batch, t_all)
        mesh_dry.finish()

    # ---- 17. kernel list ----------------------------------------------------
    phase_mark(17, t_all)
    kernels = []
    hier_launches = {"polyblock_fused": hs_launches["polyblock_fused"],
                     "polyblock_project": hstep_launches["polyblock_project"],
                     "fedavg_agg": hs_launches["fedavg_agg"]}
    for name, src, replaces, launches, res in (
            ("polyblock_fused", "src/repro_torch/csrc/polyblock.cu",
             "src/repro/kernels/polyblock_fused/kernel.py:61",
             loop_launches["polyblock_fused"], dict(k1_main[torch.float64], library_ms=None)),
            ("polyblock_project", "src/repro_torch/csrc/polyblock.cu",
             "src/repro/kernels/polyblock_project/kernel.py:39",
             step_launches["polyblock_project"], dict(k2_main[torch.float64], library_ms=None)),
            ("fedavg_agg", "src/repro_torch/csrc/fedavg_agg.cu",
             "src/repro/kernels/fedavg_agg/kernel.py:22",
             scan_launches["fedavg_agg"], k3_main),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:25",
             qwen_serve["launches"]["flash_attention"], k4_main),
            ("rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
             "src/repro/kernels/rwkv6_wkv/kernel.py:26",
             rwkv_serve["launches"]["rwkv6_wkv"], k5_main)):
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches, max_abs_err=res["max_abs_err"],
                            ms=res["ms"], plain_ms=res["plain_ms"],
                            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                            library_ms=res["library_ms"]))
        kernels[-1]["train_launches"] = {arch: r["launches"][name] for arch, r in train.items()}
        if name == "flash_attention":
            kernels[-1]["serve_launches"] = dict(
                {"qwen2-7b": launches}, **{a: r["launches"][name] for a, r in zoo.items()},
                **{a: r["launches"][name] for a, r in mla_mamba.items()},
                **{a: r["launches"][name] for a, r in audio_vlm["serve"].items()})
            keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            kernels[-1]["d80"] = {k: k4_d80[k] for k in keys}
            for label, res_k4 in audio_vlm["k4"].items():
                kernels[-1][label] = {k: res_k4[k] for k in keys}
        if name == "rwkv6_wkv":
            keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            kernels[-1]["head_block"] = {k: k5_heads[k] for k in keys}
            kernels[-1]["mesh_launches"] = shard["model"]["serve_rwkv"]["launches"][name]
        if "lanes" in res:
            kernels[-1]["lanes"] = res["lanes"]
        if name == "polyblock_fused":
            kernels[-1]["at"] = k1_at
            kernels[-1]["shard_launches"] = shard["gamma"]
        if name == "fedavg_agg":
            kernels[-1]["cells"] = {str(b): {key: r[key] for key in ("ms", "bound_ms",
                                                                     "one_cell_launches_ms")}
                                    for b, r in k3_cells.items()}
        if name in ("polyblock_fused", "fedavg_agg"):
            kernels[-1]["batch_launches"] = {agg: r["launches"][name]
                                             for agg, r in batch.items()}
            kernels[-1]["hier_batch_launches"] = {agg: r["launches"][name]
                                                  for agg, r in hier_batch.items()}
        if name in hier_launches:
            kernels[-1]["ra_backend_launches"] = {run: c[name]
                                                  for run, c in ra["launches"].items()}
            kernels[-1]["hier_launches"] = hier_launches[name]
            kernels[-1]["sweep_launches"] = sweep["launches"][name]
            kernels[-1]["service_launches"] = (service["step_launches"][name]
                                               if name == "polyblock_project"
                                               else service["launches"][name])
    line(f"total wall_s={time.perf_counter() - t_all:.1f}")
    line(json.dumps({"kernels": kernels}))
    line(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
