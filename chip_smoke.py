#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`shifu_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero with the reason on
stderr, and no result line is printed):

1. device   — CUDA must be present; prints the card's name and
               `nvidia-smi --query-gpu=name,power.limit` on a line of its own,
               then the SM count and maximum SM clock (`clocks.max.sm`).
2. build    — builds the CUDA kernels from shifu_tpu_torch/csrc (one nvcc per
               source, all started together) and prints the build seconds;
               for the flash sources, the fused block, small attention,
               the int8 layer and the rows update, each instantiation's
               registers, spills and SASS counts (HMMA, MUFU.EX2, and
               FFMA.RM or MUFU.TANH; LDG.E.128 and STG.E.128 for the rows
               update): every fused-block instantiation must have HMMA
               and no MUFU.TANH, every small-attention and int8 one HMMA,
               the rows update's f32 4-element ones 128-bit global loads
               and stores, and the training paths' instantiations (small
               attention's bf16 forward and backward at D <= 8, S <= 32;
               the int8 layer's bf16 panel kernel; the rows update's f32
               4-element Adadelta) no spills.
               While they build, a second process runs the CPU halves of
               the FT and DeepFM locksteps (phases 11-13, 15); it has
               ended before the first profile sets CUPTI up, since on the
               H100 machine profiles taken while such a process lived now
               and then lost their first device events.
3. kernels  — each kernel against its plain PyTorch version on the card, at
               the shapes its path gives it and at edge shapes, with the
               tolerance stated beside each check: the fused block (#1),
               small-token attention forward (#2) and backward (#3), the
               int8 first layer (#4, at INT8_EDGE_SHAPES: N, F and M off
               the kernel's tiles, strided and misaligned q, the three
               dtypes), the embedding lookup (#5, bitwise, with
               `F.embedding` on offset ids as its yardstick) and the
               rows-touched update (#6, bitwise, SGD and Adadelta, D 1 to
               128 in the three dtypes with deduped and with raw ids, one
               id a field, the sentinel alone; timed on a batch's deduped
               ids and on its raw ids),
               flash attention forward (#7) and its dq and dk/dv kernels
               (#8).  Device times (the profiler's
               kernel durations per call; for #7 and #8, which take
               milliseconds a call, CUDA events) of kernel, plain
               version and, for
               attention, `scaled_dot_product_attention` as a yardstick
               (forward, and forward + backward through autograd), with
               the median whole-call times (CUDA events) beside some; the
               least time the card could take (bound: bytes over the
               memory rate, operations over the peak for the compute
               dtype, or, for the attention kernels, exponentials over
               the special-function units' rate at the maximum SM clock,
               which phase 1 reads; for #1 the largest of bytes, its four
               products at the bf16 tensor-core rate times the passes of
               its f32 split, and the rest at the f32 rate, with the
               all-f32 figure beside it); the flash kernels' factors
               against SDPA, #5's against `F.embedding`, and the names of
               SDPA's kernels.
   (The FT phases 4, 5, 12 and 13 look their categorical ids up through
   #5: one launch per batch, counted in their launch checks.)
4. serve    — a full-width FT-Transformer artifact (token_dim 64, 3 layers,
   fused      8 heads, mlp_ratio 4, 30 features of which 6 categorical with
               vocab 1000, bf16 compute; random weights from a seeded
               torch.Generator) served by `ScoringDaemon(engine="torch")` on
               the card: single-row submits from several threads plus
               4096-row `score_batch` frames.  Every answer is checked against
               `TorchScorer(device="cpu")`; the fused-block kernel must have
               launched num_layers x batches dispatched times, no other.
5. serve    — the same artifact with fused_block="off": the small-attention
   unfused    forward kernel must launch, no other.
   profile  — both artifacts served once more under torch.profiler: the
               device's busy share of the wall time and its top kernels
               (gzip Chrome traces written to chiprun_out/).
6. train    — the repo's headline MLP job at full width (bench.py: 30
               features, hidden (100, 100, 100) relu, bf16, weighted_mse,
               Adadelta 0.003, batch 65536, 2,621,440 rows; int8 wire) on
               synthetic rows, 2 epochs through `train(job, ..., device=cuda)`
               on the resident tier: samples/s and metrics per epoch; the
               int8 kernel must have launched once per train step and eval
               batch, and no other kernel.
7. lockstep — 8 train steps of that job from one init on the card and on the
               CPU, on the same batches: per-step losses, and each
               parameter's change over the 8 steps, within stated
               tolerances.
8. shifu    — ModelConfig.json + ColumnConfig.json + gzip part files through
               `job_config_from_shifu` past the resident budget
               (`device_resident_bytes=0`): the loaded datasets on the
               staged tier, then `train(job)` from the files, which streams
               its first epoch from the parse and stages the second; #4's
               launches counted for each (every batch of every streamed
               block, the zero-weight tail's included).
8a. cli-cold — the operator's command, `shifu_tpu_torch.launcher.cli.main(
               ["train", ...])` in this process, on the headline MLP at full
               width from ModelConfig.json, ColumnConfig.json and a
               --globalconfig XML (batch 65536, int8 wire, staged tier, 3
               epochs, a checkpoint every epoch, a cache dir), on 1,048,576
               synthetic rows in 16 gzip parts (data/synthetic.write_files
               in a pool of processes): the first epoch streams from the
               parse, every part through the native parser; 16 v2 cache
               entries; #4 launches steps + eval batches; the losses
               bitwise those of the same command with no cache dir.  Prints
               the ingest seconds, parse rows/s, cache bytes, each epoch's
               samples/s, and the native parser's rows/s against the numpy
               tier's on 4 parts.
8b. cli-hot — the same command again: "Projected cache is hot", no
               streamed epoch, 16 cache hits and no miss; the loaded
               datasets bitwise a cache-off parse's, the losses a cache-off
               run's without the streamed epoch; the hot ingest seconds.
8c. out-of-core — `shifu.data.out-of-core=true`: the staged tier on an
               np.memmap-backed partition; #4 as in 8b; the parse and
               consolidation seconds, each epoch's samples/s.
8d. supervised — `python -m shifu_tpu_torch.launcher.cli train --supervise`
               in a subprocess, 2 epochs (`--epochs`, cut from 3 to make
               room for phase 23): an unbroken run; one whose chaos plan
               exits attempt 1 at epoch 1's start; one whose child gets
               SIGTERM in epoch 0's checkpoint save (held 5 s by a chaos
               delay) and exits 75.  Each must restart once (journaled
               `supervisor_restart`), resume at epoch 1, and end with
               per-epoch losses and final_model parameters bitwise equal to
               the unbroken run's; prints the seconds from the kill to the
               restore and to the resumed epoch's first step.
8e. serve   — 8d's final_model served by the daemon on the card, within
               SERVE_ATOL of the CPU scorer.
9. serve    — the trained headline model saved with `save_artifact` and served
   trained    by the daemon on the card, checked against the CPU scorer.
10. profile — one steady-state training epoch (epoch 1, its steps and its
               eval) under torch.profiler: busy share, top kernels, a Chrome
               trace in chiprun_out/.
10a. resume — the headline job on the staged tier (the feeder on, a
               checkpoint every epoch, 3 epochs): an unbroken run; a spawned
               child SIGKILLed after epoch 1's save; the resume here at
               epoch 2.  The per-epoch losses and the final parameters must
               equal the unbroken run's bitwise; #4 launches steps + eval
               batches of the epochs each run trained.  Prints the save and
               restore seconds, the bytes of a step and epoch 1's goodput
               buckets.
10b. sigterm — a spawned child of that job gets SIGTERM after epoch 0: it
               must save at epoch 1's first chunk boundary, exit 75 and
               journal `preemption_grace` at that step; the resume here
               trains epochs 1 and 2.
10c. feeder — the staged headline job with `overlap_epochs` on and off, 3
               epochs each (epoch 2 under the profiler): losses and order
               digests bitwise equal; step ms, samples/s, the input seconds
               exposed and hidden, the device's busy share.  Once on the
               f32 datasets held in memory (each block cast to the int8
               wire on the producing thread), then, with 10a and 10b, on
               int8 features as the loader stores them.
11. train   — the FT-Transformer rung at full width (bench.py:524-527: 30
    FT fused  numeric features, batch 8192, 131,072 rows, bf16 wire; the
               model of phase 4, dropout 0), 2 epochs on the resident tier:
               kernel #1 launches 3 x (train steps + eval batches), no other
               kernel; the 8-step card-vs-CPU lockstep at batch 1024 (FT
               locksteps compute in f32: LOCKSTEP_FT_DTYPE); the trained
               model served as in phase 9; a profiled epoch.
12. train   — the same width on the serving schema (24 numeric + 6
    FT unfused categorical, vocab 1000, float32 wire) with dropout 0.1, 1
               epoch: #2 and #3 launch 3 x train steps, and #1 3 x eval
               batches (dropout switches fusion off in training only); the
               lockstep at batch 1024 with fused_block="off", dropout 0; a
               profiled epoch, with #2's and #3's device time and share.
13. train   — attention_impl="flash" on the 1000-column schema (bench.py:
    FT flash  507-508: 1000 features, 50 categorical, S = 1001 tokens), batch
               1024, 8 steps, 1 epoch: #7 launches 3 x (steps + eval
               batches), each #8 kernel 3 x steps; the lockstep at batch 8
               (the CPU's plain attention at S = 1001 is the limit).
14. train   — DeepFM at 100k vocab (bench.py:510: 30 features, 6
    DeepFM    categorical, embedding_dim 16, hidden 100-100 relu, bf16,
               Adadelta 0.003, batch 32768; 1,048,576 rows, 65,536 valid, 1
               epoch) on the per-batch tier through the feeder (dedup on
               its assembly thread, pinned copies on its own stream) and
               the sparse update: #5 launches steps + eval batches, #6 2 x steps (two
               tables); samples/s, eval seconds, the dedup ratio, the peak
               device memory.
14a. feeder — that job with `overlap_epochs` on and off, as in 10c: order
               digests equal, losses within 1e-6 relative (the lookup's
               backward adds duplicate ids with f32 atomics); #5 and #6 as
               in phase 14.
15. lockstep — 8 steps of that job in f32, card vs CPU from one init on
               the same deduped batches: losses and every leaf's change,
               the tables and their two slots included, within 1e-2.
16. train   — the same job on the resident tier: raw ids, so #6 meets
               duplicates; the same launch counts.
17. serve   — the trained DeepFM served by the daemon, within 0.02 of the
               CPU scorer, #5 once a batch; a profiled training epoch.
18. train   — DeepFM at 4M vocab (bench.py:366-398), batch 4096, 8 steps,
               sparse update on (#6 2 x steps) and off: samples/s of each
               and their ratio, and the host time to build the 1.5 GB table.
19. train   — Wide&Deep on the 1000-column schema (bench.py:507: 50
               categorical, vocab 1000), batch 8192, 16 steps, dense update:
               #5 launches steps + eval batches.
20a. flight  — the headline MLP (full width, int8 wire, resident tier, 10
    recorder   batches an epoch, 2 epochs) with `obs.trace_epochs="first"`
               into a journal: epoch 0's capture holds #4 as many times as
               its counter moved inside the window, less what the profiler
               lost (at most half, `device_ms`'s rule; else it is retaken,
               and the phase fails after 4; the count lost is printed), its
               kernels' device time within the window, every share
               (`flops_frac`, `hbm_frac`) in (0, 1.05]; an `hbm_watermark`
               a epoch from `memory_stats` between the state's and resident
               rows' bytes and the limit; every `goodput` with
               `achieved_tflops` and `mfu` in (0, 1.05].  Prints each
               epoch's MFU and TFLOP/s, the HBM peak and the top kernels.
20b.        — the fused FT-Transformer at full width on the serving schema
               (24 numeric + 6 categorical, vocab 1000; dropout 0, so #1 and
               #5 both run), one traced epoch, held as in 20a for #1 and #5.
20c. FLOPs  — one train step of every trained path (MLP, FT fused, unfused,
               flash, DeepFM with the sparse update, Wide&Deep) at 64 rows,
               counted by obs.flops on the card and on the CPU: the FLOPs
               equal (the bytes within FLOPS_BYTES_RTOL), the MLP's its
               closed form.
20d. drills — a chaos delay in the step of the chunk one past
               `anomaly_min_chunks` journals one `anomaly` and a one-shot
               `device_profile` (trigger "anomaly"); an `obs.trace` fault
               journals `trace_fallback` and the losses are bitwise an
               untraced twin's.  No `trace_fallback` in 20a-20c.
21a. multitask — the multitask rung at full width (bench.py:511-515: 30
               features, hidden (100, 100) relu, 2 heads on 2 targets,
               bf16, weighted_mse, Adadelta 0.003, batch 32768, 32 batches
               = 1,048,576 rows, int8 wire) 2 epochs on the resident tier:
               samples/s; no kernel launches (its products are torch
               matmuls, as the JAX model's are XLA's); the 8-step
               card-vs-CPU lockstep at batch 8192 within the lockstep
               bounds; one step's FLOPs equal on the card and the CPU; the
               artifact (with its v2 op-list program and
               baseline_profile.json) scored on 4096 probe rows by
               TorchScorer on the card, the numpy op-list Scorer on the
               host and the ScoringDaemon on the card, (N, 2) each, within
               SERVE_ATOL of one another on every head.
21b. MoE     — the same for the moe_mlp rung (bench.py:516-518: 8
               experts, one head).
21c. wire    — phase 4's fused FT artifact served on the card; the
               open-loop loadtest (runtime/loadtest.py) for WIRE_SECONDS at
               a fixed offered rate, in process through the daemon's
               on_batch hook and over the socket (8 senders) to
               `serve_forever`'s wire server: achieved rows/s and exact
               p50/p99 of each mode with the card's name and power limit,
               0 errors, #1 launched 3 x and #5 once per dispatched batch
               (and no other kernel); 4096 probe rows in an f32 frame
               within SERVE_ATOL of the CPU scorer.
21d. drift, SLO — phase 9's trained headline artifact (its
               baseline_profile.json from the training loop) served with
               drift on: training-distribution frames, then frames with one
               feature shifted by 3 sigma: one feature_psi alert naming
               that feature alone; labelled feedback on held-out rows: the
               live AUC within 0.02 of `evaluate` on them.  Then a p99
               objective under 21c's measured p99: one firing p99
               slo_alert and one device_profile with trigger "slo".
22a. engines — phase 4's fused and unfused FT artifacts and phase 9's
               trained headline MLP, 4096 probe rows each through every
               engine tier of `runtime/serve.load_engine`: numpy and native
               (the C++ scorer) on the host, torch, export (scoring.pt2)
               and aot (the AOT pack: the fused artifact's at the default
               ladder, 22b's, the others' at the 4096 rung) on the card;
               native within 1e-5 of numpy, every pair within SERVE_ATOL;
               one call launches #1 3 x (#2 3 x unfused) and #5 once in
               each card tier, nothing in the host engines, no kernel for
               the MLP; rows/s of each tier at 4096-row batches (the
               card tiers in rounds torch, export, aot, aot, export,
               torch), and each card tier's enqueue and synced ms of a
               call on features already on the card.
22b. cold start — the fused pack's build seconds and bytes; fresh
               processes to their first score of the fused artifact:
               torch and export on this checkout's built kernels, aot on
               a copy of the package with an empty _build/, no nvcc on
               PATH and CUDA_HOME empty: it loads #1's and #5's libraries
               from the pack (their paths) and launches them; there the
               bare artifact raises KernelBuildError, and a copy with a
               damaged bucket file journals aot_fallback and serves
               through the export tier on the card.  Prints each tier's
               seconds from spawn to the first score.
22c. commands — `python -m shifu_tpu_torch.launcher.cli` on phase 8a's
               job: `export --checkpoint-dir` reproduces final_model
               (weights bitwise, scoring.pt2 scores equal); `score
               --engine torch`, `--engine export` and `--native` agree
               (torch and export equal); `eval --engine torch`'s AUC
               within 1e-3 of `evaluate`'s on the same rows; `serve --port
               0` under `loadtest --connect` for 3 s: rows/s, p50/p99, 0
               errors; and `score` with its default flags on phase 4's
               fused FT artifact, in this process: `auto` on the card is
               the aot tier, #1 3 x and #5 once, the aot engine's scores.
22d. views  — the operator's views as `python -m shifu_tpu_torch.launcher.
               cli` children on the journals this script wrote: `metrics`,
               `profile` and `trace` on 20a's traced journal (`trace` lists
               #4's kernel from the card with its device us), `top --once`
               on 21d's SLO daemon dir and over both 21d dirs, `drift` on
               21d's drift dir (the feature_psi alert), `timeline
               --incident` on the SLO dir (the slo_alert incident),
               `chaos-verify` on 8d's chaos drill (PASS); each one's exit 0
               and seconds.
22e. detach — `train --detach` of 8a's job (2 epochs, the cache hot,
               both traced) on the card: `status` RUNNING, `attach`
               to exit 0, `status` FINISHED, #4's kernel in its journal's
               device profile; a second detached run (2 epochs, epoch 0's
               checkpoint save held 3 s by a chaos delay) `kill`ed after
               epoch 0: every process of its tree gone within the 10 s
               grace (exit 143 after the drain), and a plain `train` on
               the same --output resumes from its save (`train_resume`).
               Prints the seconds from submit to exit and from kill to
               gone.
22f. tiering — bench.py's 10M-vocab rung on this machine's host
               (embed/tiering.TieredTable: 10M x 16, hot 2^18 rows, int8
               cold store, zipf(1.1) ids, batch 4096, 24 steps): build
               seconds, rows/s, hit rate, cold MB; `profile` renders its
               tier report.
22g. fleet   — phase 4's fused FT artifact on a `FleetManager` on the card
               (3 in-process members and 1 standby on local:2, heartbeat
               0.5 s x 3) behind `RouterServer`: the socket loadtest at 400
               rows/s from 16 senders for 8 s in a spawned process; the
               member the key k0 routes to killed 3 s after the router's
               first routed score, then, once the standby pool is
               refilled, the member all of the wire's traffic routes to
               (key "default") 5 s after it or later, while the loadtest
               still runs; 0
               errors, the router's hedge taken, one fleet_failover per
               kill, each promoting a standby on the other host; achieved
               rows/s, exact p50/p99, the seconds from each kill to
               fleet_failover and to the promoted member's first answer;
               #1 3 x and #5 once per dispatched batch and warm-up call, no
               other kernel.  Then `swap_fleet` to the unfused artifact:
               past the barrier 4096 probe rows through the router launch
               #2 and not #1 and are within SERVE_ATOL of the CPU scorer.
               `fleet-verify` (PASS), `timeline --incident` (the failover)
               and `top --once` over the member dirs (one DOWN) as CLI
               children.
22h. fleet command — `python -m shifu_tpu_torch.launcher.cli fleet` with
               `--member-mode process` (2 `serve` children and 1 standby
               child on the card, ports from a free base in the XML):
               each child's lease, and its STATS over the wire naming
               the card and its #1 and #5 launches; `loadtest
               --connect` for 3 s with 0 errors; one child's tree SIGKILLed
               and failed over; SIGTERM: exit 0 and every process gone
               within 10 s; `fleet-verify` PASS.  Prints the seconds from
               spawn to the first routed answer and from the kill to
               fleet_failover.
23a. mesh, NCCL — a spawned child with the environment contract of one
               rank (`parallel/distributed.initialize`: NCCL on cuda:0) and
               a `data=1` mesh: the headline MLP (#4, 8 steps) and the
               fused FT (#1, 4 steps) through `train(..., mesh=)`, held to
               the same job without a mesh (rtol 1e-5, atol 1e-6), the
               launches counted on the mesh run; a profile of 3 mesh steps
               must show NCCL's kernels (one gradient average a step).
               23a runs beside 23b; its profile waits for 23b's ranks to
               end.
23b. mesh, gloo — two spawned ranks on cuda:0 over gloo, which their
               placement chose (NCCL refuses two ranks of one communicator
               on one device; each rank must report gloo, "ranks share a
               card"): DeepFM at the 100k-vocab shape with its tables
               vocab-sharded over `model=2` and the sparse Adadelta (4
               steps; each rank holds V/2 rows and launches #5 and #6),
               then the MLP on `data=2` (8 steps, #4); each run's gathered
               parameters within 1e-2 of each parameter's change of a
               world-1 run here.
24a. tensor and sequence parallel — in 23b's two ranks, after its runs,
               each through `train(..., mesh=)` with the launches counted
               and its gathered parameters within 1e-2 of each parameter's
               change of the same job at world 1 here: DeepFM at the
               100k-vocab shape on Adam with the sparse plan off on
               `model=2` (the tables split by field, 3 + 3; #5 looks up
               each rank's fields), moe_mlp with 4 experts on `model=2`
               (2 experts a rank; no kernel), the headline MLP on the int8
               wire with `shifu.sharding.rules` `.*hidden_layer.*kernel` ->
               (None, model) (#4 on the gathered layer-0 kernel), and the
               FT rung's widths on 31 features (S = 32) with ring and then
               Ulysses attention on `seq=2` (#5 in the tokenizer).
24b. pipeline — three spawned ranks on cuda:0 over gloo (chosen by their
               placement, as in 23b), `pipe=3`: the FT rung (6
               categorical columns; f32, as the FT locksteps, and 24a's FT
               runs too) with pipeline_stages=3, one layer and 3
               microbatches a stage, batch 8190 (3 microbatches must divide
               it); #1 3 x and #5 once a step and an eval
               batch on every stage; its gathered parameters within 1e-2
               of each change of the stacked trunk at world 1 here, and
               its exported (per-block) artifact within SERVE_ATOL of the
               world-1 artifact on the probe rows, both on the card.
               24b runs beside 23a and 23b; 23a's profile waits for it.
24c. stacked trunk — in 23a's NCCL rank at world 1: that FT job with no
               pipe axis (the stacked trunk as one loop, #1 3 x a step)
               through `train(..., mesh=data=1)`, against the per-block
               job trained from the same seed: the canonicalized
               parameters bitwise equal, or within 1e-2 of each change
               (the script says which).
25. pod     — beside 8d, three runs at once on 8a's 16 parts and hot
               cache (the headline MLP, int8 wire, staged tier, global
               batch 65536, 32768 a host), each a gang of two simulated
               hosts whose ranks share cuda:0 (gloo, chosen by the
               placement): 25a `train --hosts local:2` (2 epochs), 25b the
               same with a chaos exit of rank 1 at `data.host_shard` in
               epoch 1 (one gang restart; per-epoch losses and final_model
               bitwise 25a's), 25c `train --provision` for 1 epoch over a
               fake gcloud (a slice of two workers at 127.0.0.1) and a
               fake ssh (the provision marker there while the gang trains,
               gone after, the slice deleted).  A sitecustomize on the
               children's PYTHONPATH writes each process's kernel counts:
               every rank launched #4 (steps + eval batches) times and no
               other kernel; `dcn_placement` says gloo; pod-verify passes
               each (25b's recovery with its one injection).  Prints each
               run's seconds and each epoch's samples/s.
a JSON line {"kernels": [...]} with each kernel's launches on its
   training path (FT fused for #1, FT unfused for #2 and #3, the headline
   MLP for #4, DeepFM for #5 and #6, FT flash for #7 and #8), its error
   against the plain version, its times and its bound; every kernel must
   have launched there.
Then the card's name and power limit, then the last line: {"ok": true,
   "device": {...}}.  Every phase prints its wall seconds (`time:`), and
   the script its total.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 20261016
# H100 SXM f32 peak on the CUDA cores (NVIDIA data sheet, dense, at the
# 700 W limit); the tensor-core and memory peaks are the package's
# (obs/goodput.PEAK_BF16_TFLOPS, obs/devprof.PEAK_HBM_GBPS), which the MFU
# and the flight recorder's roofline read too: `peaks()`
PEAK_F32_FLOPS = 67e12


def peaks() -> tuple[float, float]:
    """(bf16/f16 tensor-core FLOP/s, HBM bytes/s) of the H100 from the
    package's tables (not their environment overrides)."""
    from shifu_tpu_torch.obs import devprof, goodput
    return (dict(goodput.PEAK_BF16_TFLOPS)["h100"] * 1e12,
            dict(devprof.PEAK_HBM_GBPS)["h100"] * 1e9)

# f32 kernel against f32 plain: only the summation order differs
F32_ATOL, F32_RTOL = 1e-4, 1e-4
# bf16 output: both round one f32 result to bf16; they may land one bf16
# ulp apart (2^-7 relative at most)
BF16_ATOL, BF16_RTOL = 1e-6, 2.0 ** -7
# served probabilities, card vs CPU: bf16 compute, and the two devices
# round tokens, LayerNorm outputs and the unfused products to bf16 at
# different points (bf16 against f32 moves these scores by under 0.01)
SERVE_ATOL = 2e-2

# training lockstep, card vs CPU: bf16 compute; cuBLAS and the CPU sum the
# hidden products in other orders and may round a bf16 activation one ulp
# apart, so the losses may drift apart over the steps; 1e-2 relative is
# the bound (the losses average 65536 rows, so they agree far closer)
LOCKSTEP_RTOL = 1e-2
# each parameter's change over the lockstep's 8 steps, card vs CPU:
# |d_card - d_cpu| / |d_cpu| on the worst leaf.  Adadelta's first steps
# move each weight by about lr * sqrt(eps / (1 - rho)) * sign(g), so a
# gradient that bf16 rounds differently on the two devices moves a weight
# the other way only where g is near 0.  On an H100 the worst leaf reads
# 4.4e-4, while a leaf the card leaves unchanged reads 1 and one update of
# the 8 skipped on the card reads about 1/8
LOCKSTEP_MOVED_RTOL = 1e-2

# the headline job (bench.py:626-641, :661, :664, :798)
TRAIN_ROWS = 2_621_440
VALID_ROWS = 262_144
TRAIN_BATCH = 65536
TRAIN_EPOCHS = 2
# the Shifu-files run exercises the entry point on the per-batch tier; cut
# from 20,000 rows to keep the script's time (its steps run at batch 100)
SHIFU_ROWS = 5_000

# the kernels' shapes on the FT training paths: the fused block (B, S, D,
# H, R) and small-token attention (B, H, S, D) at batch 8192 (31 tokens,
# token_dim 64, 8 heads of 8), flash attention on the 1000-column schema at
# batch 1024 (1001 tokens)
FT_BLOCK_SHAPE = (8192, 31, 64, 8, 4)
SMALL_ATTN_SHAPE = (8192, 8, 31, 8)
FLASH_SHAPE = (1024, 8, 1001, 8)
# the embedding kernels on the DeepFM 100k-vocab training path: the lookup
# of the concatenated (6, 100000, 16 + 1) bf16 table at batch 32768, and
# the rows-touched update (U, Nc, V, D) of the f32 16-dim table
LOOKUP_SHAPE = (32768, 6, 100_000, 17)
ROWS_SHAPE = (32768, 6, 100_000, 16)
# the headline MLP's layer 0: (batch, features, hidden)
INT8_SHAPE = (65536, 30, 100)

SERVE_THREADS = 8
SERVE_ROWS_PER_THREAD = 512
SERVE_FRAMES = 2
SERVE_CLOSED_LOOP = 4 * 32   # 4 threads x 32 sequential score() calls


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()
_LAP = [_T0]


def lap(label: str) -> None:
    """Print the wall seconds since the previous lap (the script must stay
    well inside its time limit)."""
    now = time.perf_counter()
    say(f"time: {label} {now - _LAP[0]:.1f} s")
    _LAP[0] = now


# -- measurement helpers ---------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int = 10, warmup: int = 1) -> float:
    """Device time of one call from CUDA events around `reps` calls queued
    back to back behind a spin kernel of a quarter second, so that the
    host has queued them all before the card reaches the first event, and
    the time holds no host work however slow the host is; fails if the
    card reached it first."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.25 * SFU["clock_hz"]))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        fail("queued_ms: the card reached the first event before the host "
             "had queued the calls")
    end.synchronize()
    return start.elapsed_time(end) / reps


# the special-function unit's ex2 results per clock per SM, compute
# capability 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions",
# the throughput table: 16 for exp2 and the other SFU functions)
EX2_PER_CLOCK_PER_SM = 16
# (SMs, max SM clock in Hz) of the card, set by `read_sm_clock` in main
SFU = {"sms": 0, "clock_hz": 0.0}


def read_sm_clock() -> str:
    """Read the card's SM count and its maximum SM clock
    (`nvidia-smi --query-gpu=clocks.max.sm`) once, for the exponential term
    of `bound_ms`; returns a line that says them."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    text = out.stdout.strip().splitlines()[0] if out.stdout else ""
    try:
        mhz = float(text.split()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi clocks.max.sm: cannot read {text!r} "
             f"({out.stderr.strip()})")
    SFU["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    SFU["clock_hz"] = mhz * 1e6
    rate = SFU["sms"] * EX2_PER_CLOCK_PER_SM * SFU["clock_hz"]
    return (f"sfu: {SFU['sms']} SMs x {EX2_PER_CLOCK_PER_SM} ex2/clock x "
            f"clocks.max.sm {text} = {rate / 1e12:.3f} T exponentials/s")


def bound_ms(n_bytes: float, n_ops: float, dtype,
             n_exp: float = 0.0) -> tuple[float, str]:
    """The largest of bytes over the memory rate, operations over the
    card's peak for the compute dtype (the tensor-core rate for bf16/f16,
    the CUDA-core rate for f32), and exponentials over the special-function
    units' rate: SMs x 16 ex2 a clock (CUDA C++ Programming Guide,
    arithmetic-instruction throughput table, compute capability 9.0) x the
    maximum SM clock that `read_sm_clock` read."""
    import torch
    peak_16bit, peak_hbm = peaks()
    peak = (peak_16bit if dtype in (torch.bfloat16, torch.float16)
            else PEAK_F32_FLOPS)
    terms = [(n_bytes / peak_hbm * 1e3, "bytes"),
             (n_ops / peak * 1e3, "operations")]
    if n_exp:
        if not SFU["clock_hz"]:
            fail("bound_ms: the SM clock was not read (read_sm_clock)")
        rate = SFU["sms"] * EX2_PER_CLOCK_PER_SM * SFU["clock_hz"]
        terms.append((n_exp / rate * 1e3, "exponentials"))
    return max(terms, key=lambda t: t[0])


# the step programs' record_function ranges (obs/flops.instrument): their
# mirror on the device lane spans the program's kernels and is no kernel
STEP_PROGRAMS = ("train_step", "device_epoch_step", "epoch_scan_step",
                 "eval_step")


def device_events(prof) -> list:
    """(name, device µs, count) of the device-side events of a profile:
    kernels, copies, memsets.  A CPU op's self device time repeats the
    time of the kernels it launched, so CPU ops are left out, and so are
    the device-lane mirrors of `record_function` ranges."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and e.key not in STEP_PROGRAMS]


# device events the profiler dropped and saw, over every device_ms profile
PROFILE_EVENTS = {"profiles": 0, "lost": 0, "seen": 0}
PROFILE_ATTEMPTS = 4


def device_ms(fn, reps: int = 20, warmup: int = 3,
              names: list | None = None) -> float:
    """Device time of one call, from the profiler: the durations of the
    kernels it launches, without the host time between them (CUDA events
    around a call that launches a short kernel time the wrapper's host
    work).  On the H100 machine a profile dropped a few device events at
    its start (a kernel launched once a call showed reps - 1 or reps - 2
    times), and now and then it dropped them all, while another process
    lived beside this one (`main` ends its second process before the
    first profile).  So each kernel's mean duration counts
    ceil(count / reps) times a call, which holds while a kernel loses
    fewer than reps of its events; a profile in which a
    kernel lost more than half of them is taken again, and the check fails
    after PROFILE_ATTEMPTS such profiles.  (The millisecond-scale flash
    kernels, whose profiles lost every event most often, are timed with
    `queued_ms` instead: see check_flash.)  `PROFILE_EVENTS` keeps the
    tally.  `names`, when given, receives the device events' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        per_call = {n: -(-c // reps) for n, _, c in events}
        lost = sum(per_call[n] * reps - c for n, _, c in events)
        PROFILE_EVENTS["profiles"] += 1
        PROFILE_EVENTS["lost"] += lost
        PROFILE_EVENTS["seen"] += sum(c for _, _, c in events)
        if events and all(2 * (per_call[n] * reps - c) <= per_call[n] * reps
                          for n, _, c in events):
            break
        say(f"device_ms: profile {attempt + 1} of "
            f"{getattr(fn, '__qualname__', fn)} lost {lost} device events "
            f"({len(events)} kernels or copies seen)")
    else:
        fail(f"device_ms: {getattr(fn, '__qualname__', fn)}: the profiler "
             f"lost more than half of a kernel's device events in "
             f"{PROFILE_ATTEMPTS} profiles")
    if names is not None:
        names.extend(n for n, _, _ in events)
    return sum(t / c * per_call[n] for n, t, c in events) / 1e3


def randn_on(gen, device, *shape):
    """Normal samples drawn on `device` by a generator there, seeded from
    the host generator `gen`: the checks' inputs at the path shapes (4 x
    66 M values for flash) take seconds to draw on the host and copy."""
    import torch
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=dev_gen, device=device)


def warm_profiler(device) -> None:
    """One short profile on the card: the first in a process sets
    CUPTI up (about 9 s on the H100 machine's host), so that no profile a
    check reads is that one.  Run it in the thread that profiles later:
    Kineto reports an error when CUPTI was set up in another."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(8, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x + 1).sum().item()


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    err = (got.float() - want.float()).abs()
    tol = atol + rtol * want.float().abs()
    if not bool(torch_isfinite_all(got)):
        fail(f"{name}: non-finite values in the kernel's output")
    if bool((err > tol).any()):
        fail(f"{name}: max |err| {err.max().item():.3e} exceeds "
             f"atol {atol:g} + rtol {rtol:g} * |ref|")
    return float(err.max().item())


def torch_isfinite_all(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


# -- phase 3: kernels against their plain versions -------------------------

def block_params(d: int, r: int, gen, device):
    import torch
    from shifu_tpu_torch.ops.initializers import xavier_uniform

    def noise(*shape, scale):
        return torch.randn(*shape, generator=gen) * scale

    p = {"ln_attn_scale": 1 + noise(d, scale=0.1),
         "ln_attn_bias": noise(d, scale=0.1),
         "qkv_kernel": xavier_uniform((d, 3 * d), gen),
         "qkv_bias": noise(3 * d, scale=0.1),
         "proj_kernel": xavier_uniform((d, d), gen),
         "proj_bias": noise(d, scale=0.1),
         "ln_mlp_scale": 1 + noise(d, scale=0.1),
         "ln_mlp_bias": noise(d, scale=0.1),
         "mlp_in_kernel": xavier_uniform((d, r * d), gen),
         "mlp_in_bias": noise(r * d, scale=0.1),
         "mlp_out_kernel": xavier_uniform((r * d, d), gen),
         "mlp_out_bias": noise(d, scale=0.1)}
    return {k: v.to(device) for k, v in p.items()}


# the tensor-core passes a product of #1 takes: each f32 operand as bf16
# hi + lo, three mma (hi hi, hi lo, lo hi), the cheapest split that
# tests/test_torch_ft_block_numerics.py finds within F32_ATOL/F32_RTOL at
# every shape below
FT_SPLIT_PASSES = 3

# check_ft_block's edge shapes (B, S, D, H, R): the serving buckets' low
# end (B = 1, 16), a last block part full (B = 1001 at 4 samples a block),
# S at and around the 16-row m-tiles (15, 16, 17, 33) and S = 1 and 64, D
# off the mma's 16 (8, 13, 24, 40), D = 128 with hidden 1024, head dims 1,
# 8, 16 and 32 (the kernel's three attention cases), R from 1 to 8
FT_BLOCK_EDGE_SHAPES = (
    (1, 31, 64, 8, 4), (7, 9, 16, 2, 2), (5, 13, 24, 3, 3),
    (64, 64, 128, 16, 8), (3, 1, 8, 1, 1), (16, 31, 64, 8, 4),
    (1001, 31, 64, 8, 4), (600, 15, 64, 8, 4), (600, 16, 64, 8, 4),
    (600, 17, 64, 8, 4), (300, 33, 64, 8, 4), (500, 31, 40, 5, 4),
    (500, 31, 64, 8, 1), (500, 31, 64, 8, 8), (300, 31, 64, 4, 4),
    (300, 31, 64, 2, 4), (9, 5, 13, 13, 1))

def check_ft_block(device, gen) -> dict:
    import torch
    from shifu_tpu_torch.config.schema import ModelSpec
    from shifu_tpu_torch.ops import ft_block

    def case(b, s, d, h, r):
        spec = ModelSpec(model_type="ft_transformer", token_dim=d,
                         num_attention_heads=h, mlp_ratio=r)
        p = block_params(d, r, gen, device)
        x = randn_on(gen, device, b, s, d)
        got = ft_block.fused_transformer_block(x, p, spec)
        want = ft_block.block_math(x, p, h)
        torch.cuda.synchronize()
        err = check_close(f"ft_block B={b} S={s} D={d} H={h} R={r}", got,
                          want, F32_ATOL, F32_RTOL)
        return spec, p, x, err

    edge_errs = [case(*shape)[3] for shape in FT_BLOCK_EDGE_SHAPES]
    b, s, d, h, r = FT_BLOCK_SHAPE
    spec, p, x, err = case(b, s, d, h, r)
    def kernel():
        return ft_block.fused_transformer_block(x, p, spec)

    def plain():
        return ft_block.block_math(x, p, h)

    xg = x.clone().requires_grad_(True)
    pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    dy = randn_on(gen, device, *x.shape)

    def forward_backward():
        out = ft_block.fused_transformer_block(xg, pg, spec)
        return torch.autograd.grad(out, [xg, *pg.values()], dy)

    ms, plain_ms = device_ms(kernel), device_ms(plain)
    # the backward is plain PyTorch (the recompute of JAX's VJP): its device
    # time is that of forward + backward less the kernel's forward
    bwd_ms = device_ms(forward_backward) - ms
    call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
    n_bytes = ft_block.cost(b, s, d, h, r)[1]
    products, rest = ft_block.block_ops(b, s, d, h, r)
    peak_16bit, peak_hbm = peaks()
    terms = [(n_bytes / peak_hbm * 1e3, "bytes"),
             (FT_SPLIT_PASSES * products / peak_16bit * 1e3,
              f"products on the tensor cores, {FT_SPLIT_PASSES} bf16 passes"),
             (rest / PEAK_F32_FLOPS * 1e3, "the rest at the f32 rate")]
    bnd, term = max(terms)
    by = "bytes" if term == "bytes" else "operations"
    f32_bnd = (products + rest) / PEAK_F32_FLOPS * 1e3
    say(f"kernels: ft_block B={b} S={s} D={d} H={h} R={r} f32 max|err| "
        f"{err:.3e} (tol {F32_ATOL:g}+{F32_RTOL:g}*|ref|, f32 vs f32: "
        f"summation order only); edge shapes max|err| {max(edge_errs):.3e}; "
        f"device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bnd:.4f} ms ({term}; terms: "
        + ", ".join(f"{t} {v:.4f}" for v, t in terms)
        + f"; {products / 1e9:.2f} GFLOP of products, {rest / 1e9:.2f} of "
        f"the rest; all at the f32 CUDA-core rate {f32_bnd:.4f}), "
        f"kernel/bound {ms / bnd:.3f}x; whole call (CUDA events): kernel "
        f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; backward (plain "
        f"recompute, as in JAX) {bwd_ms:.4f} ms device time per block")
    return {"name": "ft_block", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/ft_block.cu",
            "replaces": "shifu_tpu/ops/pallas_ft_block.py:163",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


# The edge shapes (B, H, S, D, dtype) of check_small_attention and
# check_small_attention_bwd.  The shapes the checks had before the
# tensor-core kernels (S = 1, 9, 31, 33, 64; D = 1, 3, 8, 16; B*H = 99, 17,
# 3, not multiples of the 4 warps of a CTA), then a grid over the edges of
# the new design: S = 16, 17, 32, 33, 48, 64 about the 16-row m-tiles and
# the 32- and 64-key register tiles; D = 8 and 16 (16-byte copies) and 9
# (element loads), in the three dtypes, at B*H = 9; and three shapes of
# 9000 groups, more than a wave of warps holds, so that each warp stages
# its next group while it computes one.  The forward also at the unfused
# FT's smallest and largest serving buckets (B = 16 and 4096, H 8, S 31,
# D 8, bf16).
_SMALL_ATTN_GRID = [(3, 3, s, d, dt) for s in (16, 17, 32, 33, 48, 64)
                    for d in (8, 9, 16)
                    for dt in ("bfloat16", "float16", "float32")]
_SMALL_ATTN_MANY = [(1000, 9, 33, 9, "float16"), (1000, 9, 17, 16, "float32"),
                    (1000, 9, 64, 8, "bfloat16")]
SMALL_ATTN_EDGE_SHAPES = (
    [(1, 8, 31, 8, "bfloat16"), (9, 4, 64, 16, "float32"),
     (33, 3, 9, 3, "float32"), (5, 2, 64, 16, "bfloat16"),
     (17, 8, 31, 8, "float16"), (2, 1, 1, 1, "float32")]
    + _SMALL_ATTN_GRID + _SMALL_ATTN_MANY
    + [(16, 8, 31, 8, "bfloat16"), (4096, 8, 31, 8, "bfloat16")])
SMALL_ATTN_BWD_EDGE_SHAPES = (
    [(1, 8, 31, 8, "bfloat16"), (9, 4, 64, 16, "float32"),
     (33, 3, 9, 3, "float32"), (5, 2, 64, 16, "bfloat16"),
     (17, 1, 33, 8, "float16"), (3, 1, 1, 1, "float32"),
     (11, 3, 33, 16, "bfloat16")]
    + _SMALL_ATTN_GRID + _SMALL_ATTN_MANY)


def check_small_attention(device, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from shifu_tpu_torch.ops import small_attention as sa

    def case(b, h, s, d, dtype):
        q, k, v = (randn_on(gen, device, b, h, s, d).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        got = sa.small_token_attention(q, k, v)
        want = sa.small_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        if got.dtype != dtype:
            fail(f"small_attention returned {got.dtype}, expected {dtype}")
        atol, rtol = ((F32_ATOL, F32_RTOL) if dtype == torch.float32
                      else (BF16_ATOL, BF16_RTOL))
        err = check_close(f"small_attention B={b} H={h} S={s} D={d} "
                          f"{dtype}", got, want, atol, rtol)
        return q, k, v, scale, err

    edge_errs = [case(b, h, s, d, getattr(torch, dt))[4]
                 for b, h, s, d, dt in SMALL_ATTN_EDGE_SHAPES]
    b, h, s, d = SMALL_ATTN_SHAPE
    q, k, v, scale, err = case(b, h, s, d, torch.bfloat16)
    def kernel():
        return sa.small_token_attention(q, k, v)

    def plain():
        return sa.small_attention_plain(q, k, v, scale)

    def library():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    lib_err = (library().float() - plain().float()).abs().max().item()
    ms, plain_ms, library_ms = (device_ms(kernel), device_ms(plain),
                                device_ms(library))
    call_ms, plain_call_ms, library_call_ms = (time_ms(kernel),
                                               time_ms(plain),
                                               time_ms(library))
    n_ops, n_bytes, n_exp = sa.cost(b, h, s, d, q.dtype)
    bnd, by = bound_ms(n_bytes, n_ops, q.dtype, n_exp)
    say(f"kernels: small_attention B={b} H={h} S={s} D={d} bf16 max|err| "
        f"{err:.3e} (tol {BF16_ATOL:g}+2^-7*|ref|: one bf16 ulp); edge shapes "
        f"max|err| {max(edge_errs):.3e}; device time: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max|diff| "
        f"{lib_err:.3e}), bound {bnd:.4f} ms ({by}; {n_exp:.4g} "
        f"exponentials); whole call (CUDA "
        f"events): kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms, "
        f"sdpa {library_call_ms:.4f} ms")
    return {"name": "small_attention", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/small_attention.cu",
            "replaces": "shifu_tpu/ops/pallas_small_attention.py:187",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}


def grad_tolerance(dtype) -> tuple[float, float, str]:
    """(atol factor on max |ref|, rtol, text) for a gradient the kernel and
    its plain version both sum in f32 and round once to `dtype`: one ulp of
    the element (2^-7 bf16, 2^-10 f16; 1e-4 f32), plus the f32
    summation-order difference, which scales with the tensor's magnitude
    and not with the element's (a gradient near 0 sums terms far larger
    than itself): 2^-16 of the largest |ref| (f32: 1e-4 absolute)."""
    import torch
    if dtype == torch.float32:
        return 0.0, F32_RTOL, f"{F32_ATOL:g}+{F32_RTOL:g}*|ref|"
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    return 2.0 ** -16, ulp, (f"{'2^-7' if ulp > 1e-3 else '2^-10'}*|ref| + "
                             "2^-16*max|ref|")


def check_grad(name: str, got, want) -> float:
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: returned {got.dtype} {tuple(got.shape)}, expected "
             f"{want.dtype} {tuple(want.shape)}")
    frac, rtol, _ = grad_tolerance(want.dtype)
    atol = (F32_ATOL if want.dtype == torch.float32
            else frac * float(want.float().abs().max()) + 1e-12)
    return check_close(name, got, want, atol, rtol)


def sdpa_times(q, k, v, g, scale, names: dict | None = None
               ) -> tuple[float, float]:
    """(forward, forward + backward) device ms of
    `scaled_dot_product_attention` on these inputs: the library yardstick,
    never called by the port.  `names`, when given, receives the names of
    the device events of each ("fwd", "fwd_bwd") from the same profiles."""
    import torch
    import torch.nn.functional as F
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        return torch.autograd.grad(out, (qg, kg, vg), g)

    if names is None:
        return device_ms(fwd), device_ms(fwd_bwd)
    names["fwd"], names["fwd_bwd"] = [], []
    return (device_ms(fwd, names=names["fwd"]),
            device_ms(fwd_bwd, names=names["fwd_bwd"]))


def check_small_attention_bwd(device, gen) -> dict:
    import torch
    from shifu_tpu_torch.ops import small_attention as sa

    def case(b, h, s, d, dtype):
        q, k, v, g = (randn_on(gen, device, b, h, s, d).to(dtype)
                      for _ in range(4))
        scale = d ** -0.5
        got = sa.small_attention_bwd(q, k, v, g, scale)
        want = sa.small_attention_bwd_plain(q, k, v, g, scale)
        torch.cuda.synchronize()
        errs = [check_grad(f"small_attention_bwd {n} B={b} H={h} S={s} "
                           f"D={d} {dtype}", x, y)
                for n, x, y in zip(("dq", "dk", "dv"), got, want)]
        return q, k, v, g, scale, max(errs)

    edge_errs = [case(b, h, s, d, getattr(torch, dt))[5]
                 for b, h, s, d, dt in SMALL_ATTN_BWD_EDGE_SHAPES]
    b, h, s, d = SMALL_ATTN_SHAPE
    q, k, v, g, scale, err = case(b, h, s, d, torch.bfloat16)

    def kernel():
        return sa.small_attention_bwd(q, k, v, g, scale)

    def plain():
        return sa.small_attention_bwd_plain(q, k, v, g, scale)

    ms, plain_ms = device_ms(kernel), device_ms(plain)
    sdpa_fwd_ms, library_ms = sdpa_times(q, k, v, g, scale)
    call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
    n_ops, n_bytes, n_exp = sa.cost_bwd(b, h, s, d, q.dtype)
    bnd, by = bound_ms(n_bytes, n_ops, q.dtype, n_exp)
    say(f"kernels: small_attention_bwd B={b} H={h} S={s} D={d} bf16 max|err| "
        f"{err:.3e} over dq, dk, dv (tol {grad_tolerance(q.dtype)[2]}: one "
        f"bf16 ulp plus f32 summation order); edge shapes max|err| "
        f"{max(edge_errs):.3e}; device time: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa forward+backward {library_ms:.4f} ms (its "
        f"forward alone {sdpa_fwd_ms:.4f} ms), bound {bnd:.4f} ms ({by}; "
        f"{n_exp:.4g} exponentials); "
        f"whole call (CUDA events): kernel {call_ms:.4f} ms, plain "
        f"{plain_call_ms:.4f} ms")
    return {"name": "small_attention_bwd", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/small_attention.cu",
            "replaces": "shifu_tpu/ops/pallas_small_attention.py:209",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}


# check_flash's edge shapes: S from 1 to 1001, D from 1 to 128, the three
# dtypes; S = 63, 64, 65 and 129 sit at the kernels' 64-row tiles, D = 9
# takes the element-load staging and D = 8 the 16-byte copies
FLASH_EDGE_SHAPES = (
    [(2, 3, 1, 8, "float32"), (3, 2, 33, 16, "bfloat16"),
     (1, 5, 64, 64, "float16"), (2, 2, 1001, 8, "bfloat16"),
     (1, 3, 70, 128, "float32"), (2, 1, 130, 1, "bfloat16"),
     (1, 2, 257, 128, "bfloat16"), (3, 1, 45, 24, "float32")]
    + [(2, 3, s, d, dt) for s in (63, 64, 65, 129) for d in (8, 9)
       for dt in ("bfloat16", "float16")]
    + [(2, 2, 1001, 8, "float32"), (2, 2, 1001, 8, "float16")])


def _instantiation(mangled: str) -> str:
    """'bf16 D<=8' for a flash kernel's mangled name (its T and padded D);
    'fwd bf16 D<=8 S<=32' for a small-attention kernel's (forward or
    backward, T, D and S padded); 'KS=4 DH=8' for the fused block's (D
    padded / 16, and the head dim of its attention: 8, 16, or 0 for any
    other); 'panel bf16' for the int8 layer's (panel or tiled kernel, T);
    'f32 VEC=4 adadelta' for the rows update's (T, elements an access,
    rule)."""
    import re
    dtype = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    m = re.search(r"sa_(fwd|bwd)_kernelI(13__nv_bfloat16|6__half|f)Li(\d+)E"
                  r"Li(\d+)E", mangled)
    if m:
        return (f"{m.group(1)} {dtype[m.group(2)]} D<={m.group(3)} "
                f"S<={m.group(4)}")
    m = re.search(r"ft_block_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"KS={m.group(1)} DH={m.group(2)}"
    m = re.search(r"(panel|tiled)_kernelI(13__nv_bfloat16|6__half|f)E",
                  mangled)
    if m:
        return f"{m.group(1)} {dtype[m.group(2)]}"
    m = re.search(r"rows_update_kernelI(13__nv_bfloat16|6__half|f)Li(\d+)E"
                  r"Lb([01])E", mangled)
    if m:
        return (f"{dtype[m.group(1)]} VEC={m.group(2)} "
                f"{('sgd', 'adadelta')[int(m.group(3))]}")
    m = re.search(r"kernelI(13__nv_bfloat16|6__half|f)Li(\d+)E", mangled)
    if not m:
        return mangled[:40]
    return f"{dtype[m.group(1)]} D<={m.group(2)}"


# SASS opcodes each kernel's build line counts: HMMA (tensor-core mma);
# for flash MUFU.EX2 and FFMA.RM (the range reduction of an accurate expf,
# which its tile loops must not have); for the fused block MUFU.EX2
# (exp2f) and MUFU.TANH (tanh.approx, too coarse for its tolerance: it
# must have none); for small attention MUFU.EX2 (ex2.approx)
SASS_OPS = {"flash": ("HMMA", "MUFU.EX2", "FFMA.RM"),
            "ft_block": ("HMMA", "MUFU.EX2", "MUFU.TANH"),
            "small_attention": ("HMMA", "MUFU.EX2"),
            "int8_matmul": ("HMMA",),
            "rows_update": ("LDG.E.128", "STG.E.128")}
# the small-attention instantiations of the training path (bf16, D 8, S 31)
SMALL_ATTN_PATH_KERNELS = ("fwd bf16 D<=8 S<=32", "bwd bf16 D<=8 S<=32")
# the int8 layer's and the rows update's instantiations of the training
# paths (the MLP's bf16 panel; DeepFM's f32 D = 16 Adadelta tables)
INT8_PATH_KERNELS = ("panel bf16",)
ROWS_PATH_KERNELS = ("f32 VEC=4 adadelta",)


def build_report(src: str) -> tuple[str, dict]:
    """Per instantiation of a source: the registers and spill bytes ptxas
    reported, and the counts of SASS_OPS in its SASS, read with
    `cuobjdump -sass` from the built library where the toolkit has it.
    Returns the line and {instantiation: {op: count}} ({} without
    cuobjdump).  Shared memory is dynamic, so ptxas reports none."""
    import re
    import shutil
    from shifu_tpu_torch.ops import _build
    ops = SASS_OPS["flash" if src.startswith("flash_") else src]
    usage, cur = {}, None
    for ln in _build.build_logs.get(src, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = _instantiation(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            usage.setdefault(cur, {})["spill"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            usage.setdefault(cur, {})["regs"] = m.group(1)
    counts = {}
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(tool):
        out = subprocess.run([tool, "-sass", _build.library_path(src)],
                             capture_output=True, text=True, timeout=300)
        for fn in out.stdout.split("Function : ")[1:]:
            counts[_instantiation(fn.splitlines()[0])] = {
                op: len(re.findall(r"\b" + re.escape(op) + r"\b", fn))
                for op in ops}
    parts = []
    for key in sorted(set(usage) | set(counts)):
        u = usage.get(key, {})
        text = (f"{key} {u.get('regs', '?')} regs, spill st/ld "
                f"{u.get('spill', '?')} B")
        if key in counts:
            text += " ; SASS " + " ".join(f"{op} {n}"
                                          for op, n in counts[key].items())
        parts.append(text)
    return (" | ".join(parts) + ("" if counts else " (no cuobjdump)"),
            counts)


def check_no_spills(src: str, path_kernels: tuple) -> None:
    """The training path's instantiations of `src` spill nothing (ptxas)."""
    import re
    from shifu_tpu_torch.ops import _build
    cur = None
    for ln in _build.build_logs.get(src, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = _instantiation(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur in path_kernels and (int(m.group(1))
                                          or int(m.group(2))):
            fail(f"build: {src} {cur} (the training path's) spills: "
                 f"{ln.strip()}")


def check_small_attention_build(counts: dict) -> None:
    """Every small-attention instantiation runs its products on the tensor
    cores (HMMA in its SASS, where cuobjdump could read it), and the
    training path's forward and backward spill nothing (ptxas)."""
    if any(not c["HMMA"] for c in counts.values()):
        fail("build: a small_attention instantiation has no HMMA (the "
             "products must run on the tensor cores)")
    check_no_spills("small_attention", SMALL_ATTN_PATH_KERNELS)


def check_int8_build(counts: dict) -> None:
    """Every int8-layer instantiation runs its products on the tensor
    cores (HMMA), and the MLP's bf16 panel kernel spills nothing."""
    if any(not c["HMMA"] for c in counts.values()):
        fail("build: an int8_matmul instantiation has no HMMA (the "
             "products must run on the tensor cores)")
    check_no_spills("int8_matmul", INT8_PATH_KERNELS)


def check_rows_build(counts: dict) -> None:
    """The rows update's f32 instantiations with 4-element accesses move
    rows with 128-bit global loads and stores, and DeepFM's (Adadelta)
    spills nothing."""
    for key, c in counts.items():
        if key.startswith("f32 VEC=4") and not (c["LDG.E.128"]
                                                and c["STG.E.128"]):
            fail(f"build: rows_update {key} has no 128-bit global load or "
                 f"store: {c}")
    check_no_spills("rows_update", ROWS_PATH_KERNELS)


def check_flash(device, gen) -> list:
    """Kernels #7 (flash_fwd) and #8 (flash_bwd_dq, flash_bwd_dkv) against
    their plain versions; returns their three kernel entries.  The bound
    counts one exponential a (query, key) pair for each kernel: the
    forward's one-pass softmax adds a rescale a row a key tile, which a
    two-pass softmax would not need, so the bound leaves it out.  These
    kernels take milliseconds a call, so their device time comes from CUDA
    events, not the profiler (whose profiles of them lost every event most
    often): the kernel's over calls queued back to back behind a spin
    kernel (`queued_ms`), the plain version's (hundreds of launches a call,
    more than the launch queue holds behind the spin) around each call
    (`time_ms`), where the card, not the host, sets the pace."""
    import torch
    from shifu_tpu_torch.ops import flash_attention as fa

    def case(b, h, s, d, dtype):
        q, k, v, g = (randn_on(gen, device, b, h, s, d).to(dtype)
                      for _ in range(4))
        scale = d ** -0.5
        label = f"B={b} H={h} S={s} D={d} {dtype}"
        out, lse = fa.flash_fwd(q, k, v, scale)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, scale)
        dres = fa.flash_dres(out_p, g)
        dq = fa.flash_bwd_dq(q, k, v, g, lse_p, dres, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse_p, dres, scale)
        dq_p = fa.flash_bwd_dq_plain(q, k, v, g, lse_p, dres, scale)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, g, lse_p, dres, scale)
        torch.cuda.synchronize()
        atol, rtol = ((F32_ATOL, F32_RTOL) if dtype == torch.float32
                      else (1e-6, 2.0 ** -7 if dtype == torch.bfloat16
                            else 2.0 ** -10))
        errs = {"fwd": max(check_close(f"flash_fwd out {label}", out, out_p,
                                       atol, rtol),
                           check_close(f"flash_fwd lse {label}", lse, lse_p,
                                       F32_ATOL, F32_RTOL)),
                "dq": check_grad(f"flash_bwd_dq {label}", dq, dq_p),
                "dkv": max(check_grad(f"flash_bwd_dkv dk {label}", dk, dk_p),
                           check_grad(f"flash_bwd_dkv dv {label}", dv, dv_p))}
        return (q, k, v, g, scale, lse_p, dres), errs

    edge = [case(b, h, s, d, getattr(torch, dt))[1]
            for b, h, s, d, dt in FLASH_EDGE_SHAPES]
    b, h, s, d = FLASH_SHAPE
    (q, k, v, g, scale, lse, dres), errs = case(b, h, s, d, torch.bfloat16)
    sdpa_names = {}
    sdpa_fwd_ms, sdpa_grad_ms = sdpa_times(q, k, v, g, scale, sdpa_names)
    sdpa_bwd_ms = sdpa_grad_ms - sdpa_fwd_ms
    pairs = float(b * h) * s * s
    tol_text = (f"out one bf16 ulp (2^-7*|ref|+1e-6), lse {F32_ATOL:g}+"
                f"{F32_RTOL:g}*|ref|, grads {grad_tolerance(q.dtype)[2]}")
    specs = (
        ("flash_fwd", "fwd", "shifu_tpu/ops/pallas_attention.py:198",
         lambda: fa.flash_fwd(q, k, v, scale),
         lambda: fa.flash_fwd_plain(q, k, v, scale),
         fa.cost_fwd(b, h, s, d, q.dtype), sdpa_fwd_ms),
        ("flash_bwd_dq", "dq", "shifu_tpu/ops/pallas_attention.py:243",
         lambda: fa.flash_bwd_dq(q, k, v, g, lse, dres, scale),
         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, dres, scale),
         fa.cost_bwd_dq(b, h, s, d, q.dtype), sdpa_grad_ms),
        ("flash_bwd_dkv", "dkv", "shifu_tpu/ops/pallas_attention.py:258",
         lambda: fa.flash_bwd_dkv(q, k, v, g, lse, dres, scale),
         lambda: fa.flash_bwd_dkv_plain(q, k, v, g, lse, dres, scale),
         fa.cost_bwd_dkv(b, h, s, d, q.dtype), sdpa_grad_ms))
    entries = []
    for name, key, replaces, kernel, plain, cost, lib_ms in specs:
        ms = queued_ms(kernel)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        n_ops, n_bytes, n_exp = cost
        bnd, by = bound_ms(n_bytes, n_ops, q.dtype, n_exp)
        if key == "fwd":
            vs = (f"sdpa forward {lib_ms:.4f} ms, kernel/sdpa "
                  f"{ms / lib_ms:.3f}x")
        else:
            vs = (f"sdpa forward+backward (dq, dk, dv together) "
                  f"{lib_ms:.4f} ms, kernel/that {ms / lib_ms:.3f}x, "
                  f"kernel/sdpa backward alone {ms / sdpa_bwd_ms:.3f}x")
        say(f"kernels: {name} B={b} H={h} S={s} D={d} bf16 max|err| "
            f"{errs[key]:.3e} (tol {tol_text}); edge shapes (S 1..1001, D "
            f"1..128, f32/bf16/f16) max|err| "
            f"{max(e[key] for e in edge):.3e}; device time (CUDA events): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}; {pairs:.4g} "
            f"exponentials, one a (query, key) pair), kernel/bound "
            f"{ms / bnd:.3f}x; {vs}")
        entries.append({"name": name, "route": "cuda",
                        "source": f"shifu_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces, "max_abs_err": errs[key],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                        "bound_by": by, "library_ms": lib_ms})
    bwd_ms = entries[1]["ms"] + entries[2]["ms"]
    say(f"kernels: flash backward #8 (dq + dk/dv) {bwd_ms:.4f} ms: "
        f"{bwd_ms / sdpa_grad_ms:.3f}x sdpa forward+backward "
        f"({sdpa_grad_ms:.4f} ms), {bwd_ms / sdpa_bwd_ms:.3f}x sdpa backward "
        f"alone ({sdpa_bwd_ms:.4f} ms)")
    say(f"kernels: sdpa at B={b} H={h} S={s} D={d} bf16: forward "
        f"{sdpa_fwd_ms:.4f} ms, forward+backward {sdpa_grad_ms:.4f} ms, so "
        f"its backward takes about {sdpa_bwd_ms:.4f} ms; its device "
        f"kernels: forward {sorted(set(sdpa_names['fwd']))}, "
        f"forward+backward {sorted(set(sdpa_names['fwd_bwd']))}")
    return entries


INT8_TOL_TEXT = ("2^-7*(2|x@w|+|b|) + F*2^-24*(|x|@|w|) + 1e-6, f16 2^-10 "
                 f"in place of 2^-7, f32 {F32_ATOL:g}+{F32_RTOL:g}*|ref|")


def int8_tolerance(xc, wc, bc, dtype):
    """Allowed |kernel - plain| for the int8 product, from the operands
    rounded to the compute dtype (held in f32): the two sum the F products
    in other f32 orders (up to F * 2^-24 * (|x|@|w|) apart), then the
    rounding of the sum and the rounding after the bias add may each flip
    by one ulp, so the bound scales with |x@w| and |b|, not with |ref| (a
    result near 0 can move by a whole ulp of the unrounded product)."""
    import torch
    if dtype == torch.float32:
        return None  # F32_ATOL + F32_RTOL * |ref| through check_close
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    return (ulp * (2 * (xc @ wc).abs() + bc.abs())
            + xc.shape[1] * 2.0 ** -24 * (xc.abs() @ wc.abs()) + 1e-6)


# check_int8_matmul's edge shapes (M, F, N, dtype, offset, q's layout):
# the kernel takes a panel of 128 rows with all N <= 128 columns and F <=
# 64 features in one step, else 128 x 128 tiles over chunks of 64
# features.  N off 8 and 16 (100, 7), just past one panel (129, 257) and
# at its edge (128); F off 16 (30, 17, 1), at the panel's edge (64) and
# past it (65, 4096); M off 128 (1, 127, 129, ...); q strided (copied to
# a contiguous buffer by the wrapper) and q a contiguous view that is not
# 16-byte aligned (the tiled kernel takes it); the three dtypes
INT8_EDGE_SHAPES = (
    (1, 30, 100, "bfloat16", False, ""),
    (127, 17, 7, "float16", True, ""),
    (129, 1, 100, "float32", True, ""),
    (1000, 30, 100, "bfloat16", True, ""),
    (777, 30, 100, "float32", True, ""),
    (513, 30, 100, "float16", False, ""),
    (300, 1, 7, "bfloat16", True, ""),
    (129, 30, 129, "bfloat16", True, ""),
    (257, 17, 257, "float16", False, ""),
    (127, 30, 257, "float32", True, ""),
    (255, 64, 128, "float32", False, ""),
    (128, 65, 128, "bfloat16", True, ""),
    (129, 4096, 4096, "bfloat16", False, ""),
    (65, 4096, 33, "float32", True, ""),
    (2000, 30, 100, "bfloat16", False, "strided"),
    (1000, 17, 7, "float16", True, "strided"),
    (1001, 30, 100, "float32", True, "misaligned"),
    (129, 30, 100, "bfloat16", False, "misaligned"),
)


def check_int8_matmul(device, gen) -> dict:
    """Kernel #4 against `int8_matmul_plain` at the MLP's layer-0 shape
    (INT8_SHAPE, bf16) and at INT8_EDGE_SHAPES, within INT8_TOL_TEXT."""
    import torch
    from shifu_tpu_torch.ops import int8_matmul as i8

    def case(m, f, n, dtype, with_offset, layout=""):
        cols = 2 * f if layout == "strided" else f
        lead = 1 if layout == "misaligned" else 0
        q = torch.randint(-127, 128, (m + lead, cols), generator=gen,
                          dtype=torch.int8).to(device)
        q = q[:, ::2] if layout == "strided" else q[lead:]
        if layout == "misaligned" and q.data_ptr() % 16 == 0:
            fail(f"int8_matmul M={m} F={f}: the misaligned view is aligned")
        w = (torch.randn(f, n, generator=gen) * f ** -0.5).to(device)
        b = (torch.randn(n, generator=gen) * 0.1).to(device)
        scale = torch.full((f,), 8.0 / 127, device=device)
        offset = ((torch.randn(f, generator=gen) * 0.1).to(device)
                  if with_offset else None)
        got = i8.int8_matmul_dequant(q, w, b, scale, offset, dtype)
        want = i8.int8_matmul_plain(q, w, b, scale, offset, dtype)
        torch.cuda.synchronize()
        label = (f"int8_matmul M={m} F={f} N={n} {dtype} offset="
                 f"{with_offset}{' ' + layout + ' q' if layout else ''}")
        if got.dtype != dtype or got.shape != (m, n):
            fail(f"{label}: returned {got.dtype} {tuple(got.shape)}")
        tol = int8_tolerance(i8.dequant_plain(q, scale, offset).to(dtype)
                             .float(), w.to(dtype).float(),
                             b.to(dtype).float(), dtype)
        if tol is None:
            err = check_close(label, got, want, F32_ATOL, F32_RTOL)
        else:
            if not torch_isfinite_all(got):
                fail(f"{label}: non-finite values in the kernel's output")
            diff = (got.float() - want.float()).abs()
            if bool((diff > tol).any()):
                fail(f"{label}: max |err| {diff.max().item():.3e} exceeds "
                     f"{INT8_TOL_TEXT}")
            err = float(diff.max().item())
        return q, w, b, scale, offset, err

    edge_errs = [case(m, f, n, getattr(torch, dt), off, layout)[5]
                 for m, f, n, dt, off, layout in INT8_EDGE_SHAPES]
    m, f, n = INT8_SHAPE
    q, w, b, scale, offset, err = case(m, f, n, torch.bfloat16, False)

    def kernel():
        return i8.int8_matmul_dequant(q, w, b, scale, None, torch.bfloat16)

    def plain():
        return i8.int8_matmul_plain(q, w, b, scale, None, torch.bfloat16)

    ms, plain_ms = device_ms(kernel), device_ms(plain)
    call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
    n_ops, n_bytes, _ = i8.cost(m, f, n, torch.bfloat16, w.dtype)
    bnd, by = bound_ms(n_bytes, n_ops, torch.bfloat16)
    say(f"kernels: int8_matmul M={m} F={f} N={n} bf16 max|err| {err:.3e} "
        f"(tol {INT8_TOL_TEXT}: summation order and a rounding flip before "
        f"and after the bias add); {len(INT8_EDGE_SHAPES)} edge shapes "
        f"(N 7..4096, F 1..4096, M 1..2000, f32/bf16/f16, strided and "
        f"misaligned q) max|err| {max(edge_errs):.3e}; device time: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
        f"kernel/bound {ms / bnd:.2f}x); whole call (CUDA events): kernel "
        f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; library none (no "
        "single PyTorch call dequantizes int8 and multiplies)")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "shifu_tpu/ops/pallas_int8_matmul.py:120",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def same_bits(a, b) -> bool:
    """Bitwise equality of two float tensors (NaN rows included)."""
    import torch
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(view), b.view(view)))


# check_embedding_lookup's edge shapes (B, Nc, V, D, dtype): D 1 to 128 in
# the three dtypes, 50 fields, B off every block size; 16-byte rows
# (bf16/f16 D = 8, f32 D = 4 and 16: one vector load a run); a B * Nc * D
# that leaves a ragged last 16-byte run in each dtype (f32 105, bf16 595,
# f16 45 elements)
LOOKUP_EDGE_SHAPES = (
    (1001, 6, 1000, 1, "bfloat16"), (3, 6, 5, 16, "float32"),
    (777, 6, 1000, 64, "float16"), (257, 3, 100, 128, "float32"),
    (4099, 50, 1000, 17, "bfloat16"), (33, 1, 7, 3, "float16"),
    (999, 6, 1000, 8, "bfloat16"), (999, 6, 1000, 8, "float16"),
    (33, 2, 10, 4, "float32"), (5, 3, 100, 7, "float32"),
    (7, 5, 100, 17, "bfloat16"), (3, 3, 100, 5, "float16"))


def check_embedding_lookup(device, gen) -> dict:
    """Kernel #5 against `lookup_reference`, bitwise (a gather copies
    values): at the DeepFM training shape and at LOOKUP_EDGE_SHAPES, with
    the ids V, -1, -V and ids past [-V, V)."""
    import torch
    import torch.nn.functional as F
    from shifu_tpu_torch.ops import embedding as emb

    def case(b, nc, v, d, dtype, edge_ids=False):
        table = randn_on(gen, device, nc, v, d).to(dtype)
        ids = torch.randint(0, v, (b, nc), generator=gen, dtype=torch.int32)
        if edge_ids:
            ids.view(-1)[:7] = torch.tensor(
                [v, -1, -v, v - 1, 0, -v - 1, v + 5], dtype=torch.int32)
        ids = ids.to(device)
        got = emb.embedding_lookup(table, ids)
        want = emb.lookup_reference(table, ids)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            fail(f"embedding_lookup B={b} Nc={nc} V={v} D={d} {dtype}: not "
                 "bitwise equal to lookup_reference")
        return table, ids

    for b, nc, v, d, dt in LOOKUP_EDGE_SHAPES:
        case(b, nc, v, d, getattr(torch, dt), edge_ids=True)
    b, nc, v, d = LOOKUP_SHAPE
    table, ids = case(b, nc, v, d, torch.bfloat16)
    offset_ids = (ids.long() + torch.arange(nc, device=device) * v)
    flat_table = table.view(nc * v, d)

    def kernel():
        return emb.embedding_lookup(table, ids)

    def plain():
        return emb.lookup_reference(table, ids)

    def library():
        return F.embedding(offset_ids, flat_table)

    if not same_bits(library(), plain()):
        fail("F.embedding with offset ids differs from lookup_reference")
    # what feeds #5 on the DeepFM path at the default f32 param_dtype: the
    # 16- and 1-wide f32 tables cast to bf16 and concatenated, once a step
    tables = (randn_on(gen, device, nc, v, d - 1),
              randn_on(gen, device, nc, v, 1))

    def feed():
        return torch.cat([t.to(table.dtype) for t in tables], dim=-1)

    ms, plain_ms, library_ms = (device_ms(kernel), device_ms(plain),
                                device_ms(library))
    feed_ms = device_ms(feed)
    # the casts read f32 and write bf16, the concatenation reads and
    # writes bf16
    feed_bytes = nc * v * d * (4 + 2 + 2 * table.element_size())
    n_ops, n_bytes, _ = emb.lookup_cost(b, nc, d, table.dtype)
    bnd, by = bound_ms(n_bytes, n_ops, table.dtype)
    say(f"kernels: embedding_lookup B={b} Nc={nc} V={v} D={d} bf16 bitwise "
        f"equal to its plain version (and at edge shapes: D 1..128, "
        f"f32/bf16/f16, Nc 50, 16-byte rows, ragged last runs, ids "
        f"V/-1/-V/outside [-V, V)); device time: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, F.embedding on offset ids {library_ms:.4f} ms "
        f"(kernel/F.embedding {ms / library_ms:.3f}x), bound {bnd:.4f} ms "
        f"({by}, {n_bytes / 1e6:.1f} MB; kernel/bound {ms / bnd:.3f}x)")
    say(f"kernels: what feeds #5 on the DeepFM path (f32 tables ({nc}, {v}, "
        f"{d - 1}) and ({nc}, {v}, 1) cast to bf16 and concatenated, once a "
        f"step): {feed_ms:.4f} ms device time, {feed_bytes / 1e6:.1f} MB "
        f"moved, {feed_ms / ms:.1f}x the lookup itself")
    return {"name": "embedding_lookup", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/embedding_lookup.cu",
            "replaces": "shifu_tpu/ops/pallas_embedding.py:62",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}


ROWS_TOL_TEXT = "rtol 1e-5 atol 1e-6 (the JAX tests' own)"
# check_rows_update's edge shapes (U, Nc, V, D, dtype, rule): D 1 to 128
# over the kernel's access widths (4 elements where D % 4 == 0, else 2,
# else 1), f32/bf16/f16, each taken with deduped ids (`unique=True`) and
# with raw ids (duplicates and ids outside [0, V) among them)
ROWS_EDGE_SHAPES = tuple(
    (1000, 6, 1000, d, dt, rule)
    for d in (1, 3, 4, 16, 17, 128)
    for dt, rule in (("float32", "adadelta"), ("bfloat16", "sgd"),
                     ("float16", "adadelta"))) + (
    (4097, 6, 1000, 17, "float16", "sgd"),
    (3, 2, 5, 3, "float32", "adadelta"),
    (32768, 6, 100_000, 16, "bfloat16", "adadelta"),
    (32768, 6, 100_000, 1, "float32", "sgd"),
    (2000, 50, 1000, 16, "float32", "adadelta"))


def check_rows_update(device, gen) -> dict:
    """Kernel #6 against its plain version on the same inputs, bitwise
    (both round every f32 operation on its own) and within ROWS_TOL_TEXT:
    at ROWS_EDGE_SHAPES with deduped and with raw ids, a raw batch with
    duplicates against its deduped batch, every id of a field equal (the
    raw path's worst contention), a batch of the sentinel alone; then at
    the DeepFM path's shape (ROWS_SHAPE, f32 Adadelta) the times of a
    batch's deduped ids (`unique=True`, the per-batch tier), of its raw
    ids (the resident tier) and of the D = 1 table."""
    import torch
    from shifu_tpu_torch.embed.dedup import dedup_ids
    from shifu_tpu_torch.ops import embedding as emb

    def state(nc, v, d, dtype):
        table = randn_on(gen, device, nc, v, d).to(dtype)
        slots = tuple(randn_on(gen, device, nc, v, d).square() * 1e-3
                      for _ in range(2))
        return table, slots

    def run(fn, table, slots, g_rows, ids, rule, **kw):
        t, s = table.clone(), tuple(x.clone() for x in slots)
        fn(t, s if rule == "adadelta" else (), g_rows, ids, rule, 3e-3, **kw)
        return t, s

    def compare(label, got, want) -> tuple[float, bool]:
        (gt, gs), (wt, ws) = got, want
        err, bitwise = 0.0, True
        for g, w in zip((gt, *gs), (wt, *ws)):
            bitwise = bitwise and same_bits(g, w)
            err = max(err, check_close(label, g, w, 1e-6, 1e-5))
        return err, bitwise

    def gathered(dense_g, ids, v):
        fields = torch.arange(ids.shape[1], device=device)[None, :]
        return dense_g[fields, ids.long().clamp(0, v - 1)]

    def case(u, nc, v, d, dtype, rule, raw=False, ids=None):
        table, slots = state(nc, v, d, dtype)
        if ids is None:
            ids = torch.randint(0, v, (u, nc), generator=gen,
                                dtype=torch.int32)
            if raw:  # ids the update skips, among the duplicates
                ids.view(-1)[:4] = torch.tensor([v, -1, v + 5, -v],
                                                dtype=torch.int32)
            else:
                ids = torch.from_numpy(dedup_ids(ids.numpy(), v)[0])
            ids = ids.to(device)
        dense_g = randn_on(gen, device, nc, v, d)
        g_rows = gathered(dense_g, ids, v)
        label = (f"rows_update {rule} U={u} Nc={nc} V={v} D={d} {dtype}"
                 f"{' raw ids' if raw else ''}")
        got = run(emb.fused_rows_update, table, slots, g_rows, ids, rule,
                  unique=not raw)
        want = run(emb.rows_update_plain, table, slots, g_rows, ids, rule)
        torch.cuda.synchronize()
        err, bitwise = compare(label, got, want)
        if not bitwise:
            fail(f"{label}: not bitwise equal to rows_update_plain")
        return table, slots, g_rows, ids, err

    results = [case(un, nc_, vn, dn, getattr(torch, dt), rule, raw=raw)[4]
               for un, nc_, vn, dn, dt, rule in ROWS_EDGE_SHAPES
               for raw in (False, True)]
    u, nc, v, d = ROWS_SHAPE
    # the raw path's worst contention: every id of a field equal; and a
    # batch of the sentinel alone, which leaves the table as it was
    same = (torch.arange(nc, dtype=torch.int32) * 7)[None, :].repeat(u, 1)
    results.append(case(u, nc, v, d, torch.float32, "adadelta", raw=True,
                        ids=same.to(device))[4])
    sentinel = torch.full((u, nc), v, dtype=torch.int32, device=device)
    for raw in (False, True):
        table, slots, g_rows, _, err = case(u, nc, v, d, torch.float32,
                                            "adadelta", raw=raw,
                                            ids=sentinel)
        left = run(emb.fused_rows_update, table, slots, g_rows, sentinel,
                   "adadelta", unique=not raw)
        if not all(same_bits(x, y) for x, y in zip((left[0], *left[1]),
                                                   (table, *slots))):
            fail("rows_update: a batch of the sentinel changed the table")
        results.append(err)
    # duplicates: a raw batch equals its deduped batch (same dense grad)
    table, slots = state(nc, v, d, torch.float32)
    raw = torch.randint(0, v // 10, (u, nc), generator=gen,
                        dtype=torch.int32)
    uniq = torch.from_numpy(dedup_ids(raw.numpy(), v)[0]).to(device)
    raw = raw.to(device)
    dense_g = randn_on(gen, device, nc, v, d)
    for rule in ("sgd", "adadelta"):
        got = run(emb.fused_rows_update, table, slots,
                  gathered(dense_g, raw, v), raw, rule)
        dedup = run(emb.fused_rows_update, table, slots,
                    gathered(dense_g, uniq, v), uniq, rule, unique=True)
        plain = run(emb.rows_update_plain, table, slots,
                    gathered(dense_g, raw, v), raw, rule)
        torch.cuda.synchronize()
        err, bitwise = compare(f"rows_update {rule} raw vs plain", got,
                               plain)
        if not bitwise:
            fail(f"rows_update {rule} raw ids: not bitwise equal to "
                 "rows_update_plain")
        results.append(err)
        if not compare(f"rows_update {rule} raw vs dedup", got, dedup)[1]:
            fail(f"rows_update {rule}: a raw batch with duplicates does not "
                 "give its deduped batch's table and slots bitwise")
    # the headline: adadelta on the f32 D = 16 table of the DeepFM path, a
    # batch's deduped ids and then its raw ids
    raw = torch.randint(0, v, (u, nc), generator=gen, dtype=torch.int32)
    uniq = torch.from_numpy(dedup_ids(raw.numpy(), v)[0]).to(device)
    raw = raw.to(device)
    table, slots, g_rows, ids, err = case(u, nc, v, d, torch.float32,
                                          "adadelta", ids=uniq)
    results.append(err)
    g_raw = gathered(randn_on(gen, device, nc, v, d), raw, v)
    touched = int(((ids >= 0) & (ids < v)).sum())

    def kernel():
        return emb.fused_rows_update(table, slots, g_rows, ids, "adadelta",
                                     3e-3, unique=True)

    def kernel_raw():
        return emb.fused_rows_update(table, slots, g_raw, raw, "adadelta",
                                     3e-3)

    def plain():
        return emb.rows_update_plain(table, slots, g_rows, ids, "adadelta",
                                     3e-3)

    ms, raw_ms, plain_ms = (device_ms(kernel), device_ms(kernel_raw),
                            device_ms(plain))
    g1 = g_rows[..., :1].contiguous()
    t1, s1 = state(nc, v, 1, torch.float32)
    ms_d1 = device_ms(lambda: emb.fused_rows_update(t1, s1, g1, ids,
                                                    "adadelta", 3e-3,
                                                    unique=True))
    n_ops, n_bytes, _ = emb.rows_update_cost(u, nc, d, torch.float32,
                                             touched)
    bnd, by = bound_ms(n_bytes, n_ops, torch.float32)
    _, d1_bytes, _ = emb.rows_update_cost(u, nc, 1, torch.float32, touched)
    bnd_d1, _ = bound_ms(d1_bytes, 0.0, torch.float32)
    # the raw batch's bound counts its distinct rows once: the touched rows
    # of its deduped batch
    _, raw_bytes, _ = emb.rows_update_cost(raw.shape[0], nc, d,
                                           torch.float32, touched)
    bnd_raw, _ = bound_ms(raw_bytes, 0.0, torch.float32)
    say(f"kernels: rows_update adadelta U={u} Nc={nc} V={v} D={d} f32 "
        f"({touched} touched rows of {u * nc}, the rest the sentinel) max|err| "
        f"{err:.3e} (tol {ROWS_TOL_TEXT}); bitwise equal to its plain "
        f"version at every shape ({len(ROWS_EDGE_SHAPES)} edge shapes, D "
        f"1..128, f32/bf16/f16, SGD/Adadelta, Nc 50, each with deduped and "
        f"raw ids; every id of a field equal; the sentinel alone; raw ids "
        f"with duplicates, which give the deduped batch's rows bitwise); "
        f"max|err| over all {max(results):.3e}; device time: kernel {ms:.4f} "
        f"ms on the deduped ids (unique=True; bound {bnd:.4f} ms, {by}: "
        f"7*D*4 bytes a touched row + the ids; kernel/bound "
        f"{ms / bnd:.2f}x), {raw_ms:.4f} ms on the same batch's raw ids "
        f"({raw.numel()} entries, {touched} distinct rows; bound "
        f"{bnd_raw:.4f} ms; kernel/bound {raw_ms / bnd_raw:.2f}x), "
        f"{ms_d1:.4f} ms for the D=1 table (bound {bnd_d1:.4f} ms), plain "
        f"{plain_ms:.4f} ms; library none (no single PyTorch call gathers, "
        f"applies Adadelta and scatters)")
    return {"name": "rows_update", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/rows_update.cu",
            "replaces": "shifu_tpu/ops/pallas_embedding.py:465",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


# -- phases 4 and 5: the serving path ---------------------------------------

def serving_schema(num_features: int = 30, num_categorical: int = 6,
                   vocab: int = 1000):
    from shifu_tpu_torch.config.schema import ColumnSpec, DataSchema
    first_cat = num_features - num_categorical + 1
    cols = [ColumnSpec(0, "target", is_target=True)] + [
        ColumnSpec(i, f"f{i}", is_selected=True,
                   is_categorical=i >= first_cat,
                   vocab_size=vocab if i >= first_cat else 0)
        for i in range(1, num_features + 1)]
    return DataSchema(columns=tuple(cols), target_index=0,
                      selected_indices=tuple(range(1, num_features + 1)))


def make_rows(n: int, schema, rng) -> np.ndarray:
    """Normalized numeric features and categorical ids, a fifth of them
    past the vocab (they clip into the last bucket)."""
    from shifu_tpu_torch.models.embedding import field_layout
    layout = field_layout(schema)
    x = rng.normal(size=(n, schema.feature_count)).astype(np.float32)
    for pos, vocab in zip(layout.categorical_positions, layout.vocab_sizes):
        x[:, pos] = rng.integers(0, vocab + vocab // 4, size=n)
    return x


def drive_daemon(daemon, rows: np.ndarray, frames: list, threads: int,
                 closed_loop: int) -> tuple[np.ndarray, list, float]:
    """Single-row submits of every row from `threads` threads (open
    loop), sequential score() calls of the first `closed_loop` rows again
    spread over 4 threads, and the 4096-row frames through score_batch.
    Returns the per-row answers (open loop, then closed loop), the frame
    answers and the wall seconds."""
    n = rows.shape[0]
    answers = np.full((n, 1), np.nan, np.float32)
    errors: list = []
    per = -(-n // threads)

    def open_loop(lo, hi):
        try:
            futs = [(i, daemon.submit(rows[i])) for i in range(lo, hi)]
            for i, f in futs:
                answers[i] = f.result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    cl_rows = rows[:closed_loop]
    cl_answers = np.full((closed_loop, 1), np.nan, np.float32)

    def sequential(lo, hi):
        try:
            for i in range(lo, hi):
                cl_answers[i] = daemon.score(cl_rows[i], timeout=60)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    workers = [threading.Thread(target=open_loop,
                                args=(t * per, min(n, (t + 1) * per)))
               for t in range(threads)]
    cl_per = -(-closed_loop // 4)
    workers += [threading.Thread(target=sequential,
                                 args=(t * cl_per,
                                       min(closed_loop, (t + 1) * cl_per)))
                for t in range(4)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    frame_out = [daemon.score_batch(f) for f in frames]
    for w in workers:
        w.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(w.is_alive() for w in workers):
        fail("serving threads did not finish within 300 s")
    if errors:
        fail(f"serving raised: {errors[0]!r}")
    return np.concatenate([answers, cl_answers]), frame_out, wall


def serve_phase(label: str, export_dir: str, schema, rng, device,
                threads: int = SERVE_THREADS,
                rows_per_thread: int = SERVE_ROWS_PER_THREAD,
                n_frames: int = SERVE_FRAMES, frame_rows: int = 4096,
                closed_loop: int = SERVE_CLOSED_LOOP,
                max_batch: int = 4096) -> dict:
    """Serve `export_dir` on `device`, check every answer against the
    CPU scorer; returns stats and the kernels' launch counts."""
    from shifu_tpu_torch.config.schema import ServingConfig
    from shifu_tpu_torch.export.scorer import TorchScorer
    from shifu_tpu_torch.runtime.serve import ScoringDaemon

    rows = make_rows(threads * rows_per_thread, schema, rng)
    frames = [make_rows(frame_rows, schema, rng) for _ in range(n_frames)]
    daemon = ScoringDaemon(export_dir, config=ServingConfig(
        max_batch=max_batch), engine="torch", device=device)
    daemon.start()
    try:
        reset_launches()
        answers, frame_out, wall = drive_daemon(daemon, rows, frames,
                                                threads, closed_loop)
        launches = read_launches()
        stats = daemon.stats()
    finally:
        daemon.stop()

    ref = TorchScorer(export_dir, device="cpu")
    got = np.concatenate([answers, *frame_out])
    want = np.concatenate([ref.compute_batch(rows),
                           ref.compute_batch(rows[:closed_loop]),
                           *[ref.compute_batch(f) for f in frames]])
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{label}: answers have shape {got.shape} or are not finite")
    if not ((got >= 0) & (got <= 1)).all():
        fail(f"{label}: probabilities outside [0, 1]")
    max_err = float(np.abs(got - want).max())
    if max_err > SERVE_ATOL:
        fail(f"{label}: max |card - cpu| {max_err:.3e} > {SERVE_ATOL}")
    n_rows = rows.shape[0] + closed_loop + n_frames * frame_rows
    return {"stats": stats, "launches": launches, "max_err": max_err,
            "rows": n_rows, "wall_s": wall, "rows_per_s": n_rows / wall,
            "dispatched": stats["batches"] + stats["direct_batches"]}


def report_serve(label: str, res: dict) -> None:
    st = res["stats"]
    say(f"serve {label}: {res['rows']} rows ({st['requests']} single-row "
        f"requests in {st['batches']} batches, batch mean "
        f"{st['batch_mean']:.1f}; {st['direct_batches']} frames, {st['direct_rows']} rows) in "
        f"{res['wall_s']:.3f} s = {res['rows_per_s']:.1f} rows/s; p50 "
        f"{st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms; errors "
        f"{st['errors']}; max |card - cpu| {res['max_err']:.3e} (tol "
        f"{SERVE_ATOL:g}, bf16); launches {res['launches']}")


def profile_serve(label: str, export_dir: str, schema, rng, device,
                  out_dir: str = "chiprun_out") -> None:
    """One more serving run of `export_dir` under torch.profiler: prints
    the device's busy share of the wall time and the kernels that take the
    most device time, and writes a gzip Chrome trace to `out_dir`.  The
    profiler slows the host, so this run's wall time is not a result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from shifu_tpu_torch.config.schema import ServingConfig
    from shifu_tpu_torch.runtime.serve import ScoringDaemon

    rows = make_rows(SERVE_THREADS * SERVE_ROWS_PER_THREAD, schema, rng)
    frames = [make_rows(4096, schema, rng) for _ in range(SERVE_FRAMES)]
    daemon = ScoringDaemon(export_dir, config=ServingConfig(),
                           engine="torch", device=device).start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive_daemon(daemon, rows, frames, SERVE_THREADS,
                         SERVE_CLOSED_LOOP)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        daemon.stop()
    avgs = device_events(prof)
    busy_us = sum(t for _, t, _ in avgs)
    say(f"profile {label}: wall {wall * 1e3:.3f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e6 / wall:.2f}% of wall)")
    for key, t, n in sorted(avgs, key=lambda a: -a[1])[:8]:
        say(f"profile {label}:   {t / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"serve_{label}_trace.json.gz"))


def ft_serving_spec(fused_block: str = "auto"):
    from shifu_tpu_torch.config.schema import ModelSpec
    return ModelSpec(model_type="ft_transformer", token_dim=64, num_layers=3,
                     num_attention_heads=8, mlp_ratio=4,
                     compute_dtype="bfloat16", fused_block=fused_block)


# -- phases 6 to 10: the training path ---------------------------------------

def headline_job(epochs: int = TRAIN_EPOCHS, **data_kw):
    """The repo's headline MLP job (bench.py:626-641) on the int8 wire."""
    from shifu_tpu_torch.config.schema import (DataConfig, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    from shifu_tpu_torch.data import synthetic
    return JobConfig(
        schema=synthetic.make_schema(num_features=30),
        data=DataConfig(batch_size=TRAIN_BATCH, wire_dtype="int8", **data_kw),
        model=ModelSpec(model_type="mlp", hidden_nodes=(100, 100, 100),
                        activations=("relu", "relu", "relu"),
                        compute_dtype="bfloat16"),
        train=TrainConfig(epochs=epochs, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta",
                                                    learning_rate=0.003)),
    ).validate()


def synthetic_datasets(schema, n_train: int, n_valid: int, seed: int):
    """Train and valid partitions of `data/synthetic` rows (z-scaled
    features, a logistic target), projected as the loader projects."""
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import reader, synthetic
    cols = reader.project_columns(
        synthetic.make_rows(n_train + n_valid, schema, seed=seed), schema)

    def part(lo, hi):
        return pipe.TabularDataset(cols["features"][lo:hi],
                                   cols["target"][lo:hi],
                                   cols["weight"][lo:hi])
    return part(0, n_train), part(n_train, n_train + n_valid)


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from shifu_tpu_torch.ops import launch_counters as counters
    return counters()


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def steps_and_evals(job, n_train: int, n_valid: int,
                    epochs_run: int) -> tuple[int, int]:
    """(train steps, eval batches) of a run, from the job and the rows."""
    from shifu_tpu_torch.train.loop import eval_batch_size
    steps = epochs_run * (n_train // job.data.batch_size)
    evaluated = sum(1 for e in range(epochs_run)
                    if e % job.train.eval_every_epochs == 0
                    or e == job.train.epochs - 1)
    per_eval = -(-n_valid // eval_batch_size(job, n_valid))
    return steps, evaluated * per_eval


def run_training(label: str, job, train_ds, valid_ds, device,
                 want_tier: str, want_launches) -> tuple:
    """`train` on `device` with the launch counts set to 0 just before and
    read just after; checks the tier, the metrics, and every kernel's
    launches against `want_launches(steps, eval_batches)` (a dict by
    kernel name; a kernel it leaves out must not launch).  Returns the
    result and the launches."""
    import math
    from shifu_tpu_torch.train.loop import train

    history = []
    reset_launches()
    res = train(job, train_ds, valid_ds,
                console=lambda ln: say(f"{label}: {ln}"),
                epoch_callback=history.append, device=device)
    launches = read_launches()
    if res.tier != want_tier:
        fail(f"{label}: trained on the {res.tier!r} tier, expected "
             f"{want_tier!r}")
    steps, evals = steps_and_evals(job, train_ds.num_rows, valid_ds.num_rows,
                                   len(history))
    want = want_launches(steps, evals)
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)} ({steps} train steps, {evals} eval "
                 f"batches); all launches {launches}")
    rows_per_epoch = (train_ds.num_rows // job.data.batch_size
                      * job.data.batch_size)
    for m in history:
        if not all(math.isfinite(v) for v in
                   (m.train_error, m.valid_error, m.valid_auc)):
            fail(f"{label}: epoch {m.epoch} metrics are not finite: {m}")
        say(f"{label}: epoch {m.epoch}: {rows_per_epoch / m.epoch_time:.1f} "
            f"samples/s ({rows_per_epoch} rows in {m.epoch_time:.4f} s), "
            f"train_error {m.train_error:.6f} valid_error "
            f"{m.valid_error:.6f} valid_auc {m.valid_auc:.4f}, eval "
            f"{m.valid_time:.4f} s")
    say(f"{label}: tier {res.tier}; {steps} train steps + {evals} eval "
        f"batches; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return res, launches


def int8_launches(job):
    """The MLP on the int8 wire: each step and each eval batch sends one
    int8 batch into layer 0, and no other kernel launches."""
    from shifu_tpu_torch.train.step import wire_fused_into_model
    if not wire_fused_into_model(job):
        fail("the headline job does not feed int8 into layer 0")
    return lambda steps, evals: {"int8_matmul": steps + evals}


def lockstep_batches(job, train_ds, n_steps: int) -> list:
    """The first `n_steps` batches of the job's epoch order, cast for the
    wire as the training loop casts them; under a sparse plan with dedup
    their ids are compacted first, as on the per-batch tier."""
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.embed.dedup import attach_dedup
    from shifu_tpu_torch.train.sparse_embed import resolve_plan
    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype,
                              compact=True) or (lambda b: b)
    plan = resolve_plan(job) if job.embed.dedup != "off" else None
    dedup = (attach_dedup(plan.layout, plan.max_vocab) if plan
             else (lambda b: b))
    batches = []
    for b in pipe.batch_iterator(train_ds, job.data.batch_size,
                                 seed=job.data.shuffle_seed):
        batches.append(wcast(dedup(b)))
        if len(batches) == n_steps:
            break
    return batches


def lockstep_leaves(state) -> dict:
    """Every parameter and every sparse-table moment slot, f32 on the
    host."""
    out = {k: v.detach().cpu().float().clone()
           for k, v in state.model.state_dict().items()}
    for name, slots in (state.table_slots or {}).items():
        for i, s in enumerate(slots):
            out[f"{name}:slot{i}"] = s.detach().cpu().float().clone()
    return out


def lockstep_run(job, batches, dev) -> tuple[np.ndarray, dict, dict]:
    """Train steps over `batches` on `dev` from the job's init: (losses,
    initial leaves, each leaf's change), as numpy on the host; the leaves
    are the parameters and the sparse tables' moment slots."""
    from shifu_tpu_torch.train.loop import init_state, to_device
    from shifu_tpu_torch.train.step import make_train_step
    state = init_state(job, job.schema.feature_count, dev)
    init = lockstep_leaves(state)
    step = make_train_step(job)
    out = []
    for b in batches:
        state, m = step(state, to_device(b, job, dev))
        out.append(float(m["loss"]))
    moved = {k: (v - init[k]).numpy()
             for k, v in lockstep_leaves(state).items()}
    return np.asarray(out), {k: v.numpy() for k, v in init.items()}, moved


def lockstep(job, train_ds, device, n_steps: int = 8,
             label: str = "lockstep", cpu_ref=None) -> None:
    """`n_steps` train steps from one init on the card and on the CPU, on
    the same batches; per-step losses within LOCKSTEP_RTOL and each
    parameter's change within LOCKSTEP_MOVED_RTOL.  `cpu_ref`, when given,
    is the CPU half already run (`lockstep_run` on the CPU, by
    `cpu_lockstep_refs`)."""
    import torch
    batches = lockstep_batches(job, train_ds, n_steps)
    t0 = time.perf_counter()
    card, card_init, card_moved = lockstep_run(job, batches, device)
    card_s = time.perf_counter() - t0
    if cpu_ref is None:
        t0 = time.perf_counter()
        cpu_ref = lockstep_run(job, batches, torch.device("cpu"))
        cpu_text = f"CPU {time.perf_counter() - t0:.1f} s"
    else:
        cpu_text = "CPU half run beside the earlier phases"
    cpu, cpu_init, cpu_moved = cpu_ref
    rel = np.abs(card - cpu) / np.abs(cpu)
    if not np.all(np.isfinite(card)) or rel.max() > LOCKSTEP_RTOL:
        fail(f"{label}: card losses {card.tolist()} vs CPU {cpu.tolist()}: "
             f"max rel diff {rel.max():.3e} > {LOCKSTEP_RTOL}")
    if any(not np.array_equal(card_init[k], cpu_init[k]) for k in cpu_init):
        fail(f"{label}: the card and the CPU started from other weights")
    # the losses barely move in 8 steps (Adadelta at 0.003 changes a weight
    # by ~1e-6 a step), so the backward and the update are held here: each
    # parameter's change, card against CPU, relative to the CPU's change
    moved_rel = {}
    for k, d_cpu in cpu_moved.items():
        norm = float(np.linalg.norm(d_cpu))
        if norm == 0.0:
            fail(f"{label}: {k} did not move on the CPU in {n_steps} steps")
        moved_rel[k] = float(np.linalg.norm(card_moved[k] - d_cpu)) / norm
    worst = max(moved_rel, key=moved_rel.get)
    if not moved_rel[worst] <= LOCKSTEP_MOVED_RTOL:
        fail(f"{label}: parameter changes, card vs CPU: |d_card - d_cpu| / "
             f"|d_cpu| {moved_rel[worst]:.3e} on {worst} > "
             f"{LOCKSTEP_MOVED_RTOL:g}; per leaf {moved_rel}")
    say(f"{label}: {n_steps} steps at batch {job.data.batch_size}, card vs "
        f"CPU from one init: max rel loss diff {rel.max():.3e} (tol "
        f"{LOCKSTEP_RTOL:g}, {job.model.compute_dtype}); card losses "
        f"{[round(v, 6) for v in card.tolist()]}; parameter change "
        f"|d_card - d_cpu| / |d_cpu| worst {moved_rel[worst]:.3e} on "
        f"{worst} (tol {LOCKSTEP_MOVED_RTOL:g}); card {card_s:.1f} s, "
        f"{cpu_text}; per leaf "
        + ", ".join(f"{k} {v:.3e}" for k, v in moved_rel.items()))


def stream_launches(job, n_train: int) -> int:
    """Train steps of a streamed first epoch: every batch of every
    streamed block, the pad-only batches of a zero-weight tail included
    (train/loop.py: blocks of the staged chunk size)."""
    from shifu_tpu_torch.data import pipeline as pipe
    bs = job.data.batch_size
    row_b = pipe.wire_row_bytes(job.schema, job.data, job.model.compute_dtype)
    nb = max(1, min(job.data.block_batches, (32 << 20) // (bs * row_b)))
    pad = (job.train.loss in ("weighted_mse", "weighted_bce")
           and job.model.l2_scale <= 0)
    blocks = -(-n_train // (bs * nb)) if pad else n_train // (bs * nb)
    return blocks * nb


def shifu_files_run(tmp: str, device) -> None:
    """The Shifu user's entry point: ModelConfig.json + ColumnConfig.json +
    gzip part files -> job_config_from_shifu -> train, past the resident
    budget (device_resident_bytes=0): the loaded datasets train on the
    staged tier, and `train(job)` from the files streams its first epoch
    from the parse, then stages."""
    from shifu_tpu_torch.config import job_config_from_shifu
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import synthetic

    schema = synthetic.make_schema(num_features=30)
    data_dir = f"{tmp}/shifu_data"
    synthetic.write_files(synthetic.make_rows(SHIFU_ROWS, schema, seed=SEED),
                          data_dir, num_files=4)
    model_config = {
        "basic": {"name": "chip_smoke"},
        "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
        "train": {"validSetRate": 0.1, "numTrainEpochs": 2,
                  "algorithm": "NN",
                  "params": {"NumHiddenLayers": 3,
                             "NumHiddenNodes": [100, 100, 100],
                             "ActivationFunc": ["relu"] * 3,
                             "LearningRate": 0.003, "Propagation": "Q",
                             "Loss": "squared"}}}
    column_config = [{"columnNum": c.index, "columnName": c.name,
                      "columnFlag": "Target" if c.is_target else None,
                      "columnType": "N", "finalSelect": c.is_selected}
                     for c in schema.columns]
    with open(f"{tmp}/ModelConfig.json", "w") as f:
        json.dump(model_config, f)
    with open(f"{tmp}/ColumnConfig.json", "w") as f:
        json.dump(column_config, f)
    job = job_config_from_shifu(f"{tmp}/ModelConfig.json",
                                f"{tmp}/ColumnConfig.json",
                                data_paths=(data_dir,))
    job = job.replace(data=dataclasses.replace(
        job.data, wire_dtype="int8", device_resident_bytes=0))
    # the datasets train() streams and then retains, loaded to count
    train_ds, valid_ds = pipe.load_datasets(
        job.schema, job.data, feature_dtype=f"int8c{job.data.wire_int8_clip:g}")
    _, launches = run_training("shifu", job, train_ds, valid_ds, device,
                               want_tier="staged",
                               want_launches=int8_launches(job))
    steps, evals = steps_and_evals(job, train_ds.num_rows, valid_ds.num_rows,
                                   job.train.epochs)
    streamed = stream_launches(job, train_ds.num_rows)
    want = streamed + steps // job.train.epochs * (job.train.epochs - 1) \
        + evals
    lines = []
    reset_launches()
    from shifu_tpu_torch.train.loop import train
    res = train(job, console=lines.append, device=device)
    got = read_launches()
    if (res.tier != "staged" or got["int8_matmul"] != want
            or sum(got.values()) != want
            or not any(ln.startswith("Streaming first epoch")
                       for ln in lines)):
        fail(f"shifu: train(job) from the files launched {got} on the "
             f"{res.tier!r} tier, expected the streamed first epoch "
             f"({streamed} steps), then the staged tier: int8_matmul {want}; "
             f"console {lines}")
    say(f"shifu: job_config_from_shifu({SHIFU_ROWS} rows in 4 gzip parts) "
        f"-> {job.model.model_type} {job.model.hidden_nodes}, batch "
        f"{job.data.batch_size}, {job.train.optimizer.name}; the loaded "
        f"datasets on the staged tier launched the int8 kernel "
        f"{launches['int8_matmul']} times; train(job) from the files "
        f"streamed epoch 0 ({streamed} steps, "
        f"{res.history[0].train_error:.6f}) then staged: {want} launches")


def table_casts_ms(prof, lead: tuple) -> tuple[float, int]:
    """(device ms, calls) in a profile of the casts (aten::_to_copy) whose
    input's leading dims are `lead`: on the DeepFM path, the per-step cast
    of the embedding tables to the compute dtype that feeds kernel #5
    (models/embedding.py `table`).  Needs a profile that recorded shapes.
    (Their concatenation is not told apart here: the profiler records no
    shapes for aten::cat's list of tensors; check_embedding_lookup times
    the cast and the concatenation together.)"""
    ms, calls = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        first = (e.input_shapes or [[]])[0]
        if (e.key == "aten::_to_copy"
                and tuple(first[:len(lead)]) == tuple(lead)):
            ms += getattr(e, "device_time_total", 0.0) / 1e3
            calls += e.count
    return ms, calls


def profile_training(label: str, job, train_ds, valid_ds, device,
                     table_lead: tuple | None = None,
                     focus: dict | None = None,
                     out_dir: str = "chiprun_out") -> None:
    """A steady-state training epoch under torch.profiler: the window runs
    from the end of epoch 0 to the end of epoch 1 (its steps and its
    eval); prints the device's busy share of the window and its top
    kernels and writes a gzip Chrome trace `<label>_trace.json.gz` to
    `out_dir` (gzip keeps the traces of every profile under the 64 MiB a
    chip call may bring back).  With `table_lead`, also the device time of
    the embedding tables' casts (`table_casts_ms`); with `focus` ({label:
    a substring of kernel names}), each such kernel's device time, its
    launches and its share of the window's device time.
    The profiler slows the host, so the window's wall time is not a
    result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from shifu_tpu_torch.train.loop import train

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=table_lead is not None)
    window = {}

    def on_epoch(m) -> None:
        torch.cuda.synchronize()
        if m.epoch == 0:
            prof.start()
            window["t0"] = time.perf_counter()
        else:
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()

    two = job.replace(train=dataclasses.replace(job.train, epochs=2))
    train(two, train_ds, valid_ds, console=lambda ln: None,
          epoch_callback=on_epoch, device=device)
    avgs = device_events(prof)
    busy_us = sum(t for _, t, _ in avgs)
    if busy_us <= 0:
        fail(f"profile {label}: the profiler saw no device time")
    wall = window["wall"]
    steps = train_ds.num_rows // job.data.batch_size
    say(f"profile {label}: epoch 1 ({steps} steps + eval), wall "
        f"{wall * 1e3:.3f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.2f}% of wall)")
    for key, t, n in sorted(avgs, key=lambda a: -a[1])[:10]:
        say(f"profile {label}:   {t / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")
    for name, part in (focus or {}).items():
        t = sum(e[1] for e in avgs if part in e[0])
        n = sum(e[2] for e in avgs if part in e[0])
        say(f"profile {label}: {name}: {t / 1e3:.3f} ms over {n} launches, "
            f"{100 * t / busy_us:.2f}% of the device time; "
            f"{t / 1e3 / steps:.4f} ms a step")
    if table_lead is not None:
        ms, calls = table_casts_ms(prof, table_lead)
        say(f"profile {label}: casts of the {table_lead + ('...',)} tables "
            f"that feed #5: {ms:.3f} ms device time over the window "
            f"({calls} calls)")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"{label}_trace.json.gz"))


# -- phases 8a to 8e: the operator's `train` command on the card --------------

# the headline rows cut to 2^20 in 16 gzip parts (writing gzip text is the
# limit of the script's time), 3 epochs with a checkpoint every epoch
CLI_ROWS = 1_048_576
CLI_FILES = 16
CLI_EPOCHS = 3
SUP_EPOCHS = 2   # 8d's supervised runs: depth cut from 3 for phase 23
CLI_CHILD_TIMEOUT_S = 300
# the parse tiers timed on this many of the parts, one file after another
CLI_PARSE_FILES = 4


def _write_cli_part(args) -> None:
    """One gzip part through `data/synthetic.write_files` (in a pool
    process): written beside the data dir, then renamed into it."""
    from shifu_tpu_torch.data import synthetic
    chunk, data_dir, i = args
    tmp_dir = f"{data_dir}.w{i}"
    (path,) = synthetic.write_files(chunk, tmp_dir, num_files=1)
    os.replace(path, os.path.join(data_dir, f"part-{i:05d}.gz"))
    os.rmdir(tmp_dir)


def write_cli_files(tmp: str) -> tuple:
    """ModelConfig.json, ColumnConfig.json and the headline's rows (cut to
    CLI_ROWS, from SEED) in CLI_FILES gzip parts, written by a pool of
    processes; returns (schema, data dir, seconds)."""
    from shifu_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    schema = synthetic.make_schema(num_features=30)
    rows = synthetic.make_rows(CLI_ROWS, schema, seed=SEED)
    data_dir = f"{tmp}/cli_data"
    os.makedirs(data_dir)
    chunks = np.array_split(rows, CLI_FILES)
    with multiprocessing.get_context("spawn").Pool(
            min(CLI_FILES, len(os.sched_getaffinity(0)))) as pool:
        pool.map(_write_cli_part,
                 [(c, data_dir, i) for i, c in enumerate(chunks)])
    model_config = {
        "basic": {"name": "chip_smoke_cli"},
        "dataSet": {"targetColumnName": "target", "dataDelimiter": "|"},
        "train": {"validSetRate": 0.1, "numTrainEpochs": CLI_EPOCHS,
                  "algorithm": "NN",
                  "params": {"NumHiddenLayers": 3,
                             "NumHiddenNodes": [100, 100, 100],
                             "ActivationFunc": ["relu"] * 3,
                             "LearningRate": 0.003, "Propagation": "Q",
                             "Loss": "squared"}}}
    column_config = [{"columnNum": c.index, "columnName": c.name,
                      "columnFlag": "Target" if c.is_target else None,
                      "columnType": "N", "finalSelect": c.is_selected}
                     for c in schema.columns]
    with open(f"{tmp}/cli_ModelConfig.json", "w") as f:
        json.dump(model_config, f)
    with open(f"{tmp}/cli_ColumnConfig.json", "w") as f:
        json.dump(column_config, f)
    return schema, data_dir, time.perf_counter() - t0


def cli_xml(tmp: str, name: str, data_keys: dict) -> str:
    """A --globalconfig XML: batch 65536, the int8 wire, the staged tier
    (device-resident-bytes 0), 3 epochs, and the `shifu.data.*` keys of
    `data_keys`."""
    from shifu_tpu_torch.utils import xmlconfig
    path = f"{tmp}/{name}.xml"
    xmlconfig.write_configuration_xml({
        "shifu.application.batch-size": str(TRAIN_BATCH),
        "shifu.application.epochs": str(CLI_EPOCHS),
        "shifu.data.wire-dtype": "int8",
        "shifu.data.device-resident-bytes": "0",
        **{f"shifu.data.{k}": v for k, v in data_keys.items()}}, path)
    return path


def cli_argv(tmp: str, data_dir: str, xml: str, out: str, device) -> list:
    """The train command's arguments; on the card the default device
    (cuda:0), as an operator runs it."""
    argv = ["train", "--modelconfig", f"{tmp}/cli_ModelConfig.json",
            "--columnconfig", f"{tmp}/cli_ColumnConfig.json",
            "--data", data_dir, "--globalconfig", xml, "--output", out]
    return argv + (["--device", "cpu"] if device.type == "cpu" else [])


def cli_run(label: str, argv: list) -> dict:
    """`launcher.cli.main(argv)` in this process with the launch counts set
    to 0 just before and read just after; returns the launches, the
    per-epoch metrics, the console board and the journal."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.launcher import cli

    reset_launches()
    t0 = time.perf_counter()
    code = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    obs.flush()
    out = argv[argv.index("--output") + 1]
    if code != 0:
        fail(f"{label}: the train command exited {code}")
    with open(f"{out}/metrics.jsonl") as f:
        metrics = [json.loads(ln) for ln in f if ln.strip()]
    with open(f"{out}/console.board") as f:
        board = f.read()
    return {"launches": launches, "metrics": metrics, "board": board,
            "journal": journal(f"{out}/telemetry"), "wall_s": wall,
            "out": out}


def cli_losses(metrics: list) -> list:
    return [(m["epoch"], m["train_error"], m["valid_error"], m["valid_auc"])
            for m in metrics]


def check_cli_launches(label: str, run: dict, want: int) -> None:
    got = run["launches"]
    if got["int8_matmul"] != want or sum(got.values()) != want:
        fail(f"{label}: launches {got}, expected int8_matmul {want} (train "
             "steps + eval batches) and no other kernel")


def cli_samples(run: dict, rows_per_epoch: int) -> str:
    """Each epoch's samples/s and ms a step (batch TRAIN_BATCH)."""
    steps = rows_per_epoch // TRAIN_BATCH
    return ", ".join(f"epoch {m['epoch']} "
                     f"{rows_per_epoch / m['epoch_time']:.1f} "
                     f"({1e3 * m['epoch_time'] / steps:.3f} ms a step)"
                     for m in run["metrics"])


def ingest_report(run: dict) -> dict:
    reports = [r for r in run["journal"] if r["kind"] == "ingest_report"]
    if len(reports) != 1:
        fail(f"{run['out']}: {len(reports)} ingest reports, expected 1")
    return reports[0]


def parse_tiers_rows_per_s(data_dir: str) -> tuple:
    """Rows/s of the native parser and of the numpy tier on the same
    CLI_PARSE_FILES parts, one file after another (a host-side call)."""
    from shifu_tpu_torch.data import native_parser, reader
    files = reader.list_data_files(data_dir)[:CLI_PARSE_FILES]
    out = []
    for env in (None, "1"):
        if env:
            os.environ["SHIFU_TPU_NO_NATIVE_PARSER"] = env
        native_parser.reset_for_tests()
        t0 = time.perf_counter()
        rows = sum(reader.read_file(p).shape[0] for p in files)
        out.append((rows / (time.perf_counter() - t0),
                    reader.last_io_stats()["tier"]))
        os.environ.pop("SHIFU_TPU_NO_NATIVE_PARSER", None)
    native_parser.reset_for_tests()
    if [t for _, t in out] != ["native", "numpy"]:
        fail(f"parse tiers: {out}")
    return out[0][0], out[1][0]


def find_child(out: str, timeout_s: float) -> int:
    """The pid of the supervised train child writing to `out` (not its
    supervisor): the process whose command line names `out` without
    --supervise."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().split(b"\0")
            except OSError:
                continue
            if (b"shifu_tpu_torch.launcher.cli" in cmd
                    and out.encode() in cmd and b"--supervise" not in cmd):
                return int(pid)
        time.sleep(0.05)
    fail(f"no train child for {out} within {timeout_s} s")


def supervised_run(label: str, argv: list, plan=None, on_start=None) -> dict:
    """`python -m shifu_tpu_torch.launcher.cli train --supervise ...` in a
    subprocess; `plan` goes to SHIFU_TPU_CHAOS_PLAN, `on_start(proc)` runs
    while it trains.  Returns its output, journal, final parameters."""
    out = argv[argv.index("--output") + 1]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    if plan is not None:
        env["SHIFU_TPU_CHAOS_PLAN"] = json.dumps(plan)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *argv,
         "--supervise"], env=env, cwd=os.path.dirname(
             os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        if on_start is not None:
            on_start(proc)
        stdout, _ = proc.communicate(timeout=CLI_CHILD_TIMEOUT_S)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        fail(f"{label}: the supervised command exited {proc.returncode}: "
             f"{stdout[-3000:]}")
    with np.load(f"{out}/final_model/weights.npz") as z:
        weights = {k: z[k] for k in z.files}
    return {"stdout": stdout, "journal": journal(f"{out}/telemetry"),
            "weights": weights, "wall_s": time.perf_counter() - t0}


def journal_losses(recs: list) -> dict:
    return {r["epoch"]: (r["train_error"], r["valid_error"], r["valid_auc"])
            for r in recs if r["kind"] == "epoch"}


def check_supervised(label: str, run: dict, unbroken: dict,
                     want_rc: int) -> tuple:
    """One restart with `want_rc`, and the unbroken run's per-epoch losses
    and final parameters, bitwise; returns the restart and the resumes."""
    restarts = [r for r in run["journal"] if r["kind"] == "supervisor_restart"]
    resumes = [r for r in run["journal"] if r["kind"] == "train_resume"]
    if (len(restarts) != 1 or restarts[0]["rc"] != want_rc
            or "succeeded after 2 attempts" not in run["stdout"]):
        fail(f"{label}: supervisor restarts {restarts} (expected one, rc "
             f"{want_rc}); output {run['stdout'][-2000:]}")
    if journal_losses(run["journal"]) != journal_losses(unbroken["journal"]):
        fail(f"{label}: per-epoch losses {journal_losses(run['journal'])} "
             f"against the unbroken {journal_losses(unbroken['journal'])}")
    if (sorted(run["weights"]) != sorted(unbroken["weights"])
            or not all(np.array_equal(run["weights"][k],
                                      unbroken["weights"][k])
                       for k in run["weights"])):
        fail(f"{label}: final_model's parameters differ from the unbroken "
             "run's")
    return restarts[0], resumes


def cli_phases(tmp: str, device, smi_line: str = "") -> None:
    """Phases 8a-8e: the operator's `train` command on the headline MLP;
    phase 25, the pod, runs beside 8d."""
    import dataclasses as dc

    from shifu_tpu_torch import obs
    from shifu_tpu_torch.data import cache as cache_lib
    from shifu_tpu_torch.data import native_parser, reader
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.launcher import cli
    from shifu_tpu_torch.train.loop import train

    if not native_parser.available():
        fail("cli: the native parser did not build: "
             f"{native_parser.unavailable_reason()}")
    schema, data_dir, write_s = write_cli_files(tmp)
    cache_dir = f"{tmp}/cli_cache"
    xml_cache = cli_xml(tmp, "cli_cache", {"cache-dir": cache_dir})
    xml_off = cli_xml(tmp, "cli_off", {})
    xml_ooc = cli_xml(tmp, "cli_ooc", {"cache-dir": f"{tmp}/cli_ooc_cache",
                                       "out-of-core": "true"})

    def argv(xml: str, out: str) -> list:
        return cli_argv(tmp, data_dir, xml, f"{tmp}/{out}", device)

    args = cli.build_parser().parse_args(argv(xml_cache, "cli_probe"))
    job = cli._assemble_job(args, write_files=False)[0]
    fd = f"int8c{job.data.wire_int8_clip:g}"
    if (job.model.hidden_nodes != (100, 100, 100)
            or job.train.optimizer.name != "adadelta"
            or job.data.batch_size != TRAIN_BATCH
            or job.data.wire_dtype != "int8"):
        fail(f"cli: the Shifu files assembled another job: {job}")
    say(f"cli: {CLI_ROWS} rows in {CLI_FILES} gzip parts written in "
        f"{write_s:.2f} s (data/synthetic.write_files, a pool of processes)")

    # 8a: cold, streamed from the parse through the native parser
    cold = cli_run("8a cli-cold", argv(xml_cache, "cli_cold"))
    rep = ingest_report(cold)
    parsers = sorted({r.get("parser") for r in rep["per_file"]})
    if (rep["mode"] != "stream" or rep["tiers"] != {"parse": CLI_FILES}
            or parsers != ["native"] or len(rep["per_file"]) != CLI_FILES):
        fail(f"8a cli-cold: ingest report {rep['mode']} {rep['tiers']}, "
             f"parsers {parsers}: expected {CLI_FILES} files streamed "
             "through the native parser")
    if "Streaming first epoch" not in cold["board"]:
        fail("8a cli-cold: the first epoch did not stream")
    entries = [e for e in cache_lib.scan_cache(cache_dir)
               if e["tier"] == "projected" and e["status"] == "ok"]
    if len(entries) != CLI_FILES or any(e["version"] != 2 for e in entries):
        fail(f"8a cli-cold: {len(entries)} v2 entries in the cache, "
             f"expected {CLI_FILES}")
    train_ds, valid_ds = pipe.load_datasets(
        job.schema, dc.replace(job.data, cache_dir=cache_dir),
        feature_dtype=fd)
    n_tr, n_va = train_ds.num_rows, valid_ds.num_rows
    steps, evals = steps_and_evals(job, n_tr, n_va, CLI_EPOCHS)
    streamed = stream_launches(job, n_tr)
    want_stream = streamed + steps // CLI_EPOCHS * (CLI_EPOCHS - 1) + evals
    check_cli_launches("8a cli-cold", cold, want_stream)
    off = cli_run("8a cli-cold, cache off", argv(xml_off, "cli_off"))
    check_cli_launches("8a cli-cold, cache off", off, want_stream)
    if cli_losses(cold["metrics"]) != cli_losses(off["metrics"]):
        fail(f"8a cli-cold: losses {cli_losses(cold['metrics'])} against "
             f"the cache-off run's {cli_losses(off['metrics'])}")
    native_rps, numpy_rps = parse_tiers_rows_per_s(data_dir)
    rows_per_epoch = n_tr // TRAIN_BATCH * TRAIN_BATCH
    cold_ingest = rep["wall_s"]
    say(f"8a cli-cold: train --globalconfig (cache dir set) streamed epoch "
        f"0 from {CLI_FILES} parts, all through the native parser: ingest "
        f"{cold_ingest:.3f} s ({rep['rows'] / cold_ingest:.1f} rows/s over "
        f"a pool of {rep['pool_width']}; parse {rep['parse_s']:.3f} s, "
        f"cache writes {rep['write_s']:.3f} s summed over files), "
        f"{sum(e['bytes'] for e in entries)} cache bytes in {CLI_FILES} v2 "
        f"entries; samples/s {cli_samples(cold, rows_per_epoch)}; "
        f"int8_matmul {cold['launches']['int8_matmul']} launches ({streamed} "
        f"streamed steps + {steps // CLI_EPOCHS * (CLI_EPOCHS - 1)} staged "
        f"+ {evals} eval batches); losses bitwise equal to the cache-off "
        f"run's; one file after another, native parser {native_rps:.1f} "
        f"rows/s against the numpy tier's {numpy_rps:.1f} "
        f"({native_rps / numpy_rps:.1f}x)")
    lap("8a cli-cold")

    # 8b: hot, loaded from the v2 entries
    hits0 = obs.counter("data_cache_hits_total").total()
    miss0 = obs.counter("data_cache_misses_total").total()
    hot = cli_run("8b cli-hot", argv(xml_cache, "cli_hot"))
    hits = int(obs.counter("data_cache_hits_total").total() - hits0)
    misses = int(obs.counter("data_cache_misses_total").total() - miss0)
    hrep = ingest_report(hot)
    if ("Projected cache is hot for every input file: skipping the "
            "streamed first epoch" not in hot["board"]
            or "Streaming first epoch" in hot["board"]
            or hits != CLI_FILES or misses != 0
            or hrep["tiers"] != {"cache": CLI_FILES}):
        fail(f"8b cli-hot: {hits} cache hits, {misses} misses, ingest tiers "
             f"{hrep['tiers']}; board {hot['board'][-1500:]}")
    check_cli_launches("8b cli-hot", hot, steps + evals)
    off_tr, off_va = pipe.load_datasets(
        job.schema, dc.replace(job.data, cache_dir=None), feature_dtype=fd)
    for name, a, b in (("train", train_ds, off_tr),
                       ("valid", valid_ds, off_va)):
        for key in ("features", "target", "weight"):
            if not np.array_equal(np.asarray(getattr(a, key)),
                                  getattr(b, key)):
                fail(f"8b cli-hot: the cached {name} {key} differ from a "
                     "cache-off parse")
    ref = train(job.replace(
        data=dc.replace(job.data, cache_dir=None, stream_first_epoch=False),
        runtime=dc.replace(job.runtime, checkpoint=dc.replace(
            job.runtime.checkpoint, directory=""))),
        console=lambda ln: None, device=device)
    want = [(m.epoch, m.train_error, m.valid_error, m.valid_auc)
            for m in ref.history]
    if cli_losses(hot["metrics"]) != want:
        fail(f"8b cli-hot: losses {cli_losses(hot['metrics'])} against a "
             f"cache-off run without the streamed epoch {want}")
    say(f"8b cli-hot: 'Projected cache is hot' -> loaded: {hits} cache "
        f"hits, 0 misses; ingest {hrep['wall_s']:.3f} s hot against "
        f"{cold_ingest:.3f} s cold; the loaded datasets bitwise equal to a "
        f"cache-off parse, the losses to a cache-off run without the "
        f"streamed epoch; samples/s {cli_samples(hot, rows_per_epoch)}; "
        f"int8_matmul {hot['launches']['int8_matmul']} = {steps} steps + "
        f"{evals} eval batches")
    del off_tr, off_va, ref
    lap("8b cli-hot")

    # 8c: out of core, the staged tier on memory-mapped arrays
    ooc = cli_run("8c out-of-core", argv(xml_ooc, "cli_ooc"))
    check_cli_launches("8c out-of-core", ooc, steps + evals)
    ooc_tr, _ = pipe.load_datasets(
        job.schema, dc.replace(job.data, cache_dir=f"{tmp}/cli_ooc_cache",
                               out_of_core=True), feature_dtype=fd)
    tiers = {r["tier"] for r in ooc["journal"]
             if r["kind"] == "overlap_report"}
    if not isinstance(ooc_tr.features, np.memmap) or tiers != {"staged"} \
            or ooc_tr.num_rows != n_tr:
        fail(f"8c out-of-core: features {type(ooc_tr.features).__name__} "
             f"({ooc_tr.num_rows} rows), tiers {tiers}: expected the staged "
             f"tier on an np.memmap of {n_tr} rows")
    orep = ingest_report(ooc)
    if orep["mode"] != "outofcore" or sorted(
            {r.get("parser") for r in orep["per_file"]}) != ["native"]:
        fail(f"8c out-of-core: ingest report {orep['mode']}, parsers "
             f"{sorted({r.get('parser') for r in orep['per_file']})}: "
             "expected every part parsed by the native parser")
    g0 = next(r for r in ooc["journal"] if r["kind"] == "goodput"
              and r["epoch"] == 0)
    ooc_dirs = [e for e in cache_lib.scan_cache(f"{tmp}/cli_ooc_cache")
                if e["tier"] == "dataset"]
    say(f"8c out-of-core: parse ({orep['files']} parts through the native "
        f"parser, a pool of {orep['pool_width']}: {orep['wall_s']:.3f} s) + "
        f"consolidate into memory-mapped int8 arrays "
        f"({sum(e['bytes'] for e in ooc_dirs)} bytes), charged to epoch 0's "
        f"input bucket: {g0['buckets']['input']:.3f} s; samples/s "
        f"{cli_samples(ooc, rows_per_epoch)}; int8_matmul "
        f"{ooc['launches']['int8_matmul']} = steps + eval batches")
    del ooc_tr, train_ds, valid_ds
    obs.reset_for_tests()  # the in-process runs' sinks
    lap("8c out-of-core")

    # 8d: supervised, SUP_EPOCHS epochs; a chaos exit at the last epoch's
    # start, and a SIGTERM drain.  The three jobs run at once, each in its
    # own dir on the card (their checks compare them with each other)
    def sup_argv(out: str) -> list:
        return argv(xml_cache, out) + ["--epochs", str(SUP_EPOCHS)]

    last = SUP_EPOCHS - 1
    kill_plan = {"faults": [{"site": "train.epoch_start", "at_epoch": last,
                             "action": "exit", "scope": "job",
                             "max_times": 1}]}
    term_out = f"{tmp}/cli_sup_term"

    def send_term(proc) -> None:
        # the child stalls 5 s in epoch 0's checkpoint save; SIGTERM lands
        # there, and the drain at that epoch boundary exits 75
        import signal
        deadline = time.monotonic() + CLI_CHILD_TIMEOUT_S
        board = f"{term_out}/console.board"
        while True:
            if proc.poll() is not None or time.monotonic() > deadline:
                fail("8d supervised, SIGTERM: the child ended before "
                     "epoch 0 did")
            if os.path.exists(board) and "Epoch 0:" in open(board).read():
                break
            time.sleep(0.02)
        os.kill(find_child(term_out, 10.0), signal.SIGTERM)

    term_plan = {"faults": [{"site": "checkpoint.save", "at_call": 1,
                             "action": "delay", "delay_s": 5,
                             "scope": "job"}]}
    from concurrent.futures import ThreadPoolExecutor
    # phase 25 (the pod, on 8a's parts and hot cache) beside 8d: both are
    # child processes' start-ups, neither profiles
    pod_pool = ThreadPoolExecutor(1)
    pod_run = pod_pool.submit(pod_phases, device, tmp, smi_line)
    with ThreadPoolExecutor(3) as pool:
        futures = [
            pool.submit(supervised_run, "8d supervised, unbroken",
                        sup_argv("cli_sup_unbroken")),
            pool.submit(supervised_run, "8d supervised, chaos",
                        sup_argv("cli_sup_killed"), plan=kill_plan),
            pool.submit(supervised_run, "8d supervised, SIGTERM",
                        sup_argv("cli_sup_term"), plan=term_plan,
                        on_start=send_term)]
        unbroken, killed, termed = (f.result() for f in futures)
    restart, resumes = check_supervised("8d supervised, chaos", killed,
                                        unbroken, 17)
    if [r["epoch"] for r in resumes] != [last]:
        fail(f"8d supervised, chaos: resumed at {resumes}, expected epoch "
             f"{last}")
    inject = next(r for r in killed["journal"]
                  if r["kind"] == "chaos_inject")
    resumed = next(r for r in killed["journal"] if r["kind"] == "epoch"
                   and r["epoch"] == last)
    first_step = (resumed["ts"] - resumed["epoch_time"]
                  - resumed["valid_time"])
    _, term_resumes = check_supervised("8d supervised, SIGTERM", termed,
                                       unbroken, 75)
    grace = [r for r in termed["journal"] if r["kind"] == "preemption_grace"]
    if [r["epoch"] for r in term_resumes] != [1] or len(grace) != 1:
        fail(f"8d supervised, SIGTERM: resumed {term_resumes}, "
             f"preemption_grace {grace}: expected a drain at epoch 1")
    say(f"8d supervised ({SUP_EPOCHS} epochs): the chaos exit at epoch "
        f"{last}'s start (attempt 1, rc {restart['rc']}) restarted once and "
        f"resumed at epoch {last}: "
        f"{resumes[0]['ts'] - inject['ts']:.3f} s from the kill to the "
        f"restore, {first_step - inject['ts']:.3f} s to the resumed epoch's "
        f"first step; the SIGTERM drain (exit 75 after epoch 0's save) "
        f"restarted once and resumed at epoch 1; per-epoch losses and "
        f"final_model's parameters of both bitwise equal to the unbroken "
        f"supervised run's; walls unbroken {unbroken['wall_s']:.1f} s, "
        f"chaos {killed['wall_s']:.1f} s, SIGTERM {termed['wall_s']:.1f} s")
    lap("8d supervised")
    pod_run.result()
    pod_pool.shutdown()
    lap("25 pod (beside 8d: the seconds past 8d's end)")

    # 8e: the supervised job's artifact served on the card
    served = serve_phase("8e serve", f"{tmp}/cli_sup_killed/final_model",
                         job.schema, np.random.default_rng(SEED), device)
    report_serve("8e cli-trained", served)
    lap("8e serve")


# -- phases 10a to 10c: resume, SIGTERM drain and the feeder -----------------

RESUME_EPOCHS = 3
CHILD_TIMEOUT_S = 300


def staged_headline_job(directory: str = "", overlap: bool = True,
                        epochs: int = RESUME_EPOCHS):
    """The headline job past the resident budget (the staged tier), with a
    checkpoint every epoch in `directory`."""
    job = headline_job(epochs=epochs, device_resident_bytes=0,
                       overlap_epochs=overlap)
    return job.replace(runtime=dataclasses.replace(
        job.runtime, checkpoint=dataclasses.replace(
            job.runtime.checkpoint, directory=directory,
            save_every_epochs=1)))


def int8_datasets(job, *datasets) -> tuple:
    """The datasets with their features on the job's int8 wire grid, as
    `load_datasets(..., feature_dtype="int8c8")` stores them."""
    from shifu_tpu_torch.data import pipeline as pipe
    scale, offset = pipe.wire_params(job.schema, job.data)
    return tuple(pipe.TabularDataset(
        pipe.wire_quantize(ds.features, scale, offset), ds.target, ds.weight)
        for ds in datasets)


def save_headline_datasets(tmp: str, train_ds, valid_ds) -> None:
    for part, ds in (("train", train_ds), ("valid", valid_ds)):
        for key in ("features", "target", "weight"):
            np.save(f"{tmp}/headline_{part}_{key}.npy", getattr(ds, key))


def load_headline_datasets(tmp: str) -> tuple:
    from shifu_tpu_torch.data import pipeline as pipe
    return tuple(pipe.TabularDataset(*(
        np.load(f"{tmp}/headline_{part}_{key}.npy")
        for key in ("features", "target", "weight")))
        for part in ("train", "valid"))


def journal(path: str) -> list:
    from shifu_tpu_torch import obs
    return obs.read_journal(os.path.join(path, "journal.jsonl"))


def configure_obs(path: str) -> None:
    from shifu_tpu_torch import obs
    obs.reset_for_tests()
    obs.configure(path, flush_every=1)


def train_child(tmp: str, job_json: str, device: str, mode: str) -> None:
    """A spawned process training `job_json` (the staged headline job,
    checkpointing in its directory) on `device`.
    mode "kill": after epoch 1 (its checkpoint is saved before the
    callback) it writes its losses to `<directory>.history.json` and
    SIGKILLs itself.  mode "term": after epoch 0 it writes
    `<directory>.ready` and waits for `<directory>.sent`, which the parent
    creates once it has sent SIGTERM; the drain then lands at the first
    chunk boundary of epoch 1.  Its journal goes to `<directory>.tele`."""
    import signal
    import torch
    from shifu_tpu_torch.config.schema import JobConfig
    from shifu_tpu_torch.train.loop import train

    job = JobConfig.from_dict(json.loads(job_json))
    directory = job.runtime.checkpoint.directory
    configure_obs(f"{directory}.tele")
    train_ds, valid_ds = load_headline_datasets(tmp)
    history = []

    def on_epoch(m) -> None:
        history.append([m.epoch, m.train_error, m.valid_error, m.valid_auc])
        if mode == "kill" and m.epoch == 1:
            with open(f"{directory}.history.json", "w") as f:
                json.dump(history, f)
            os.kill(os.getpid(), signal.SIGKILL)
        if mode == "term" and m.epoch == 0:
            open(f"{directory}.ready", "w").close()
            while not os.path.exists(f"{directory}.sent"):
                time.sleep(0.01)

    train(job, train_ds, valid_ds, console=lambda ln: None,
          epoch_callback=on_epoch, device=torch.device(device))


def spawn_child(tmp: str, job, device, mode: str):
    """`train_child` in a spawned process; the job and the device travel
    as arguments, the datasets as .npy files in `tmp`."""
    proc = multiprocessing.get_context("spawn").Process(
        target=train_child, args=(tmp, job.to_json(), str(device), mode))
    proc.start()
    return proc


def join_child(proc, label: str) -> int:
    proc.join(CHILD_TIMEOUT_S)
    if proc.is_alive():
        proc.kill()
        proc.join()
        fail(f"{label}: the child did not end within {CHILD_TIMEOUT_S} s")
    return proc.exitcode


def staged_block_batches(job) -> int:
    from shifu_tpu_torch.data import pipeline as pipe
    bs = job.data.batch_size
    row_b = pipe.wire_row_bytes(job.schema, job.data, job.model.compute_dtype)
    return max(1, min(job.data.block_batches, (32 << 20) // (bs * row_b)))


def check_int8_run(label: str, job, n_train: int, n_valid: int,
                   epochs_run: int, res) -> None:
    """#4 launched once a train step and eval batch of the epochs that
    ran, and no other kernel; the tier is staged."""
    steps, evals = steps_and_evals(job, n_train, n_valid, epochs_run)
    got = read_launches()
    want = {k: 0 for k in got}
    want["int8_matmul"] = steps + evals
    if got != want or res.tier != "staged":
        fail(f"{label}: launches {got} on the {res.tier!r} tier, expected "
             f"{want} ({steps} steps + {evals} eval batches) on 'staged'")


def resume_phase(tmp: str, device, train_ds, valid_ds) -> None:
    """Phase 10a: the staged headline job, the feeder on, a checkpoint
    every epoch, 3 epochs: unbroken; then a spawned child SIGKILLed after
    epoch 1's save, resumed here.  Losses bitwise equal to the unbroken
    run's; #4 launches for the epochs that ran."""
    import torch
    from shifu_tpu_torch.train import checkpoint as ckpt_lib
    from shifu_tpu_torch.train.loop import train

    n_tr, n_va = train_ds.num_rows, valid_ds.num_rows
    configure_obs(f"{tmp}/unbroken.tele")
    reset_launches()
    job = staged_headline_job(f"{tmp}/unbroken")
    unbroken = train(job, train_ds, valid_ds, console=lambda ln: None,
                     device=device)
    check_int8_run("resume: unbroken", job, n_tr, n_va, RESUME_EPOCHS,
                   unbroken)
    recs = journal(f"{tmp}/unbroken.tele")
    saves = [r["dur_s"] for r in recs if r["kind"] == "checkpoint_save"]
    goodput = next(r for r in recs if r["kind"] == "goodput"
                   and r["epoch"] == 1)
    newest = ckpt_lib.latest_step(ckpt_lib.make_manager(f"{tmp}/unbroken"))
    step_dir = f"{tmp}/unbroken/{newest}"
    step_bytes = sum(os.path.getsize(os.path.join(step_dir, n))
                     for n in os.listdir(step_dir))

    killed = f"{tmp}/killed"
    code = join_child(spawn_child(tmp, staged_headline_job(killed), device,
                                  "kill"), "resume")
    if code != -9:
        fail(f"resume: the child exited {code}, expected -9 (SIGKILL after "
             "epoch 1's save)")
    with open(f"{killed}.history.json") as f:
        first = json.load(f)
    configure_obs(f"{killed}.resume.tele")
    reset_launches()
    resumed = train(staged_headline_job(killed), train_ds, valid_ds,
                    console=lambda ln: None, device=device)
    check_int8_run("resume: resumed", job, n_tr, n_va, len(resumed.history),
                   resumed)
    restores = [r["dur_s"] for r in journal(f"{killed}.resume.tele")
                if r["kind"] == "checkpoint_restore"]
    got = [h[1] for h in first] + [m.train_error for m in resumed.history]
    want = [m.train_error for m in unbroken.history]
    if resumed.resumed_from_epoch != 2 or got != want:
        fail(f"resume: resumed at epoch {resumed.resumed_from_epoch} "
             f"(expected 2); losses killed + resumed {got} against "
             f"unbroken {want}: not bitwise equal")
    for a, b in zip(resumed.state.model.state_dict().values(),
                    unbroken.state.model.state_dict().values()):
        if not torch.equal(a, b):
            fail("resume: the resumed parameters differ from the unbroken "
                 "run's")
    say(f"resume: staged headline job ({RESUME_EPOCHS} epochs, feeder on, a "
        f"checkpoint every epoch): killed (SIGKILL) after epoch 1's save, "
        f"resumed at epoch 2; per-epoch train_error {got} bitwise equal to "
        f"the unbroken run's, and so are the final parameters; a step "
        f"holds {step_bytes} bytes; save {min(saves):.4f}-{max(saves):.4f} "
        f"s (blocking, {len(saves)} saves); restore "
        f"{', '.join(f'{r:.4f}' for r in restores)} s; epoch 1's goodput "
        f"buckets {goodput['buckets']} (wall {goodput['wall_s']} s, "
        f"goodput fraction {goodput['goodput_fraction']})")


def sigterm_phase(tmp: str, device, train_ds, valid_ds) -> None:
    """Phase 10b: a child training the staged headline job gets SIGTERM
    after epoch 0; it saves at the first chunk boundary of epoch 1 and
    exits 75; the journal holds `preemption_grace` at that step; the
    resume here finishes the epochs."""
    import math
    import signal
    from shifu_tpu_torch.train import checkpoint as ckpt_lib
    from shifu_tpu_torch.train.loop import train

    d = f"{tmp}/term"
    job = staged_headline_job(d)
    proc = spawn_child(tmp, job, device, "term")
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while not os.path.exists(f"{d}.ready"):
        if not proc.is_alive() or time.monotonic() > deadline:
            join_child(proc, "sigterm")
            fail(f"sigterm: the child ended (exit {proc.exitcode}) before "
                 "epoch 0 did")
        time.sleep(0.01)
    os.kill(proc.pid, signal.SIGTERM)
    open(f"{d}.sent", "w").close()
    code = join_child(proc, "sigterm")
    spe = train_ds.num_rows // job.data.batch_size
    drain = spe + min(staged_block_batches(job), spe)
    latest = ckpt_lib.latest_step(ckpt_lib.make_manager(d))
    grace = [r for r in journal(f"{d}.tele")
             if r["kind"] == "preemption_grace"]
    if code != 75 or latest != drain or len(grace) != 1 or (
            grace[0]["step"], grace[0]["epoch"], grace[0]["saved"]) \
            != (drain, 1, True):
        fail(f"sigterm: exit {code} (expected 75), newest checkpoint step "
             f"{latest} (expected the drain step {drain}), "
             f"preemption_grace events {grace}")
    reset_launches()
    res = train(job, train_ds, valid_ds, console=lambda ln: None,
                device=device)
    check_int8_run("sigterm: resumed", job, train_ds.num_rows,
                   valid_ds.num_rows, len(res.history), res)
    if (res.resumed_from_epoch != 1
            or [m.epoch for m in res.history] != list(range(1, RESUME_EPOCHS))
            or not all(math.isfinite(m.train_error) for m in res.history)):
        fail(f"sigterm: the resume ran epochs "
             f"{[m.epoch for m in res.history]} from "
             f"{res.resumed_from_epoch}, expected 1..{RESUME_EPOCHS - 1}")
    say(f"sigterm: the child got SIGTERM after epoch 0, saved step {drain} "
        f"(epoch 1, chunk 1 of {-(-spe // staged_block_batches(job))}) and "
        f"exited 75; preemption_grace {grace[0]}; the resume replayed "
        f"epochs 1-{RESUME_EPOCHS - 1}: train_error "
        f"{[round(m.train_error, 6) for m in res.history]}")


def feeder_pair(label: str, tmp: str, job, train_ds, valid_ds, device,
                want_tier: str, want_launches, tol: float = 0.0,
                why: str = "") -> None:
    """The job with the overlap on and off, 3 epochs each: epochs 0 and 1
    timed, epoch 2 under the profiler for the device's busy share.  Losses
    and order digests bitwise equal on and off (`tol` > 0: within that
    relative difference, for the reason `why`); launch counts per
    `want_launches`."""
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    from shifu_tpu_torch.train.loop import train

    out = {}
    for overlap in (True, False):
        run = job.replace(
            data=dataclasses.replace(job.data, overlap_epochs=overlap),
            train=dataclasses.replace(job.train, epochs=3))
        tele = f"{tmp}/feeder_{label}_{overlap}"
        configure_obs(tele)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        window = {}

        def on_epoch(m, prof=prof, window=window) -> None:
            torch.cuda.synchronize()
            if m.epoch == 1:
                prof.start()
                window["t0"] = time.perf_counter()
            elif m.epoch == 2:
                window["wall"] = time.perf_counter() - window["t0"]
                prof.stop()

        reset_launches()
        res = train(run, train_ds, valid_ds, console=lambda ln: None,
                    epoch_callback=on_epoch, device=device)
        got = read_launches()
        steps, evals = steps_and_evals(run, train_ds.num_rows,
                                       valid_ds.num_rows, 3)
        want = want_launches(steps, evals)
        if res.tier != want_tier or any(
                n != want.get(k, 0) for k, n in got.items()):
            fail(f"feeder {label}: overlap {overlap}: launches {got} on the "
                 f"{res.tier!r} tier, expected {want} on {want_tier!r}")
        busy_us = sum(t for _, t, _ in device_events(prof))
        reports = {r["epoch"]: r for r in journal(tele)
                   if r["kind"] == "overlap_report"}
        out[overlap] = (res, reports, busy_us / 1e6 / window["wall"])
    (on, rep_on, busy_on), (off, rep_off, busy_off) = out[True], out[False]
    lo = [m.train_error for m in on.history]
    lf = [m.train_error for m in off.history]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lo, lf))
    digests_equal = all(rep_on[e]["order_digest"] == rep_off[e]["order_digest"]
                        is not None for e in rep_on)
    if not digests_equal or not all(map(math.isfinite, lo)) or rel > tol:
        fail(f"feeder {label}: losses on {lo} off {lf} (max rel diff "
             f"{rel:.3e}, tol {tol:g}); order digests equal: "
             f"{digests_equal}")
    spe = train_ds.num_rows // job.data.batch_size
    rows = spe * job.data.batch_size
    for name, res, rep, busy in (("on", on, rep_on, busy_on),
                                 ("off", off, rep_off, busy_off)):
        m = res.history[1]
        r = rep[1]
        say(f"feeder {label}: overlap {name}: epoch 1 {m.epoch_time * 1e3 / spe:.3f} "
            f"ms a step, {rows / m.epoch_time:.1f} samples/s; input exposed "
            f"{r['input_exposed_s']:.4f} s, hidden {r['input_hidden_s']:.4f} "
            f"s, production {r['input_production_s']:.4f} s, prefetched "
            f"{r['prefetched_chunks']}; epoch 2 under the profiler: device "
            f"busy {100 * busy:.2f}% of wall (kernels and copies summed)")
    say(f"feeder {label}: losses on and off "
        + ("bitwise equal" if lo == lf else
           f"within {rel:.3e} relative (tol {tol:g}: {why})")
        + f"; order digests equal on every epoch ({rep_on[1]['tier']} tier)")


def training_phases(device, tmp: str, kernels: list,
                    smi_line: str = "") -> None:
    from shifu_tpu_torch.export.artifact import save_artifact

    job = headline_job()
    t0 = time.perf_counter()
    train_ds, valid_ds = synthetic_datasets(job.schema, TRAIN_ROWS,
                                            VALID_ROWS, SEED)
    say(f"train: {train_ds.num_rows} train + {valid_ds.num_rows} valid "
        f"synthetic rows made in {time.perf_counter() - t0:.2f} s; job: 30 "
        f"features, hidden {job.model.hidden_nodes} relu, "
        f"{job.model.compute_dtype}, {job.train.loss}, "
        f"{job.train.optimizer.name} {job.train.optimizer.learning_rate:g}, "
        f"batch {job.data.batch_size}, wire {job.data.wire_dtype}")
    res, launches = run_training("train", job, train_ds, valid_ds, device,
                                 want_tier="resident",
                                 want_launches=int8_launches(job))
    set_launches(kernels, launches, ("int8_matmul",))
    lap("train")
    lockstep(job, train_ds, device)
    lap("lockstep")
    shifu_files_run(tmp, device)
    lap("shifu")
    cli_phases(tmp, device, smi_line)

    export_dir = save_artifact(res.state.model, job.model, job.schema,
                               f"{tmp}/trained_mlp",
                               baseline_profile=res.baseline_profile)
    served = serve_phase("trained", export_dir, job.schema,
                         np.random.default_rng(SEED), device)
    report_serve("trained", served)
    profile_training("train", job, train_ds, valid_ds, device)
    lap("serve trained and profile train")

    # the staged phases train on int8 features, as the loader stores them
    # under the int8 wire (quantized once at parse); f32 datasets held in
    # memory are cast block by block on the producing thread instead
    feeder_pair("MLP f32 in memory", tmp, staged_headline_job(), train_ds,
                valid_ds, device, "staged", int8_launches(job))
    lap("feeder MLP f32 in memory")
    tr8, va8 = int8_datasets(job, train_ds, valid_ds)
    del train_ds, valid_ds
    save_headline_datasets(tmp, tr8, va8)
    resume_phase(tmp, device, tr8, va8)
    lap("resume")
    sigterm_phase(tmp, device, tr8, va8)
    lap("sigterm")
    feeder_pair("MLP", tmp, staged_headline_job(), tr8, va8, device,
                "staged", int8_launches(job))
    lap("feeder MLP")


# -- phases 11 to 13: training the FT-Transformer -----------------------------

# the FT-Transformer rung of bench.py (:524-527, :540-543): token_dim 64, 3
# layers, 8 heads, mlp_ratio 4, bf16, weighted_mse, Adadelta 0.003, batch
# 8192, 16 blocks; 30 numeric features on the bf16 wire
FT_TRAIN_ROWS = 16 * 8192
FT_VALID_ROWS = 16_384
FT_BATCH = 8192
FT_EPOCHS = 2
# flash: the 1000-column schema of bench.py:507-508 (1000 features, 50
# categorical, vocab 1000: 1001 tokens with the CLS token) at batch 1024,
# 8 steps and one eval batch, to spend little chip time: at this batch one
# step's attention alone is about 0.8 TFLOP forward
FLASH_BATCH = 1024
FLASH_STEPS = 8
FLASH_VALID_ROWS = 2048
LOCKSTEP_FT_BATCH = 1024
# the CPU's plain attention at S = 1001 is the limit of the flash lockstep
LOCKSTEP_FLASH_BATCH = 8
# the FT locksteps compute in f32, so that card and CPU differ in summation
# order only.  In bf16 the unfused block rounds to bf16 some 20 times per
# block on each device at other points, and over 8 steps that moved a
# one-element leaf (the head bias) 2.2e-2 apart on an H100, the other
# leaves 3e-3 to 1.3e-2: noise of the size of the faults the check is for
# (a leaf left unmoved reads 1, one update skipped of 8 about 1/8)
LOCKSTEP_FT_DTYPE = "float32"


def ft_job(schema, batch: int, epochs: int, **model_kw):
    from shifu_tpu_torch.config.schema import (DataConfig, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    return JobConfig(
        schema=schema, data=DataConfig(batch_size=batch),
        model=ModelSpec(model_type="ft_transformer", token_dim=64,
                        num_layers=3, num_attention_heads=8, mlp_ratio=4,
                        compute_dtype="bfloat16", **model_kw),
        train=TrainConfig(epochs=epochs, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta",
                                                    learning_rate=0.003)),
    ).validate()


def set_launches(kernels: list, launches: dict, names) -> None:
    for kr in kernels:
        if kr["name"] in names:
            kr["launches"] = launches[kr["name"]]


def with_batch(job, batch: int, **model_kw):
    return job.replace(
        data=dataclasses.replace(job.data, batch_size=batch),
        model=dataclasses.replace(job.model, **model_kw))


def ft_unfused_job():
    """Path A, unfused: dropout switches fusion off in training only, so
    kernels #2 and #3 run every step and kernel #1 every eval batch; 6
    categorical columns with vocab 1000 take the f32 embedding scatter."""
    from shifu_tpu_torch.data import synthetic
    cat_schema = synthetic.make_schema(num_features=30, num_categorical=6,
                                       vocab_size=1000)
    return ft_job(cat_schema, FT_BATCH, 1, dropout_rate=0.1)


def ft_paths() -> dict:
    """The three FT training paths, label -> (job, lockstep job, train
    dataset, valid dataset), from SEED alone: the process that runs the
    locksteps' CPU halves builds the same ones."""
    from shifu_tpu_torch.data import synthetic
    # path A, fused (the defaults): kernel #1 in every step and eval batch,
    # its backward the plain recompute
    fused = ft_job(synthetic.make_schema(num_features=30), FT_BATCH,
                   FT_EPOCHS)
    unfused = ft_unfused_job()
    cat_schema = unfused.schema
    # path B, flash attention at 1001 tokens: kernels #7 and #8
    wide = synthetic.make_schema(num_features=1000, num_categorical=50,
                                 vocab_size=1000)
    flash = ft_job(wide, FLASH_BATCH, 1, attention_impl="flash")
    return {
        "FT fused": (
            fused, with_batch(fused, LOCKSTEP_FT_BATCH,
                              compute_dtype=LOCKSTEP_FT_DTYPE),
            *synthetic_datasets(fused.schema, FT_TRAIN_ROWS, FT_VALID_ROWS,
                                SEED)),
        "FT unfused": (
            unfused, with_batch(unfused, LOCKSTEP_FT_BATCH, fused_block="off",
                                dropout_rate=0.0,
                                compute_dtype=LOCKSTEP_FT_DTYPE),
            *synthetic_datasets(cat_schema, FT_TRAIN_ROWS, FT_VALID_ROWS,
                                SEED + 1)),
        "FT flash": (
            flash, with_batch(flash, LOCKSTEP_FLASH_BATCH,
                              compute_dtype=LOCKSTEP_FT_DTYPE),
            *synthetic_datasets(wide, FLASH_STEPS * FLASH_BATCH,
                                FLASH_VALID_ROWS, SEED + 2)),
    }


def cpu_lockstep_refs(n_steps: int = 8) -> dict:
    """The CPU halves of the three FT locksteps and of the DeepFM one,
    label -> `lockstep_run` on the CPU.  `main` runs this in a process of
    its own while the kernels build: on the 8-core host of the H100
    machine the FT halves took 35-51 s in the script's main thread."""
    import torch
    paths = {**ft_paths(), "DeepFM": deepfm_lockstep_path()}
    return {label: lockstep_run(job, lockstep_batches(job, tr, n_steps),
                                torch.device("cpu"))
            for label, (_, job, tr, _) in paths.items()}


def ft_training_phases(device, tmp: str, kernels: list,
                       cpu_refs: dict) -> None:
    from shifu_tpu_torch.export.artifact import save_artifact

    layers = 3
    paths = ft_paths()
    fused, fused_lock, tr, va = paths["FT fused"]
    say(f"train FT fused: {tr.num_rows} train + {va.num_rows} valid rows, 30 "
        f"numeric features (S=31 with CLS), token_dim 64, 3 layers, 8 heads, "
        f"mlp_ratio 4, bf16, {fused.train.loss}, adadelta 0.003, batch "
        f"{FT_BATCH}, {FT_EPOCHS} epochs, fused_block auto, dropout 0")
    res, launches = run_training(
        "train FT fused", fused, tr, va, device, want_tier="resident",
        want_launches=lambda st, ev: {"ft_block": layers * (st + ev)})
    set_launches(kernels, launches, ("ft_block",))
    lap("train FT fused")
    lockstep(fused_lock, tr, device, label="lockstep FT fused",
             cpu_ref=cpu_refs["FT fused"])
    lap("lockstep FT fused")
    export_dir = save_artifact(res.state.model, fused.model, fused.schema,
                               f"{tmp}/trained_ft")
    # fewer rows than the serving phases: the CPU reference scores every
    # row at full width, ~9 s for their 12,416
    served = serve_phase("trained FT", export_dir, fused.schema,
                         np.random.default_rng(SEED), device,
                         rows_per_thread=128, n_frames=1)
    report_serve("trained FT", served)
    profile_training("train_ft", fused, tr, va, device)
    lap("serve trained FT and profile train_ft")

    unfused, unfused_lock, tr_c, va_c = paths["FT unfused"]
    say(f"train FT unfused: the same width and rows on 24 numeric + 6 "
        f"categorical (vocab 1000) features, float32 wire, dropout 0.1, "
        f"fused_block auto, 1 epoch")
    _, launches = run_training(
        "train FT unfused", unfused, tr_c, va_c, device, want_tier="resident",
        want_launches=lambda st, ev: {"small_attention": layers * st,
                                      "small_attention_bwd": layers * st,
                                      "ft_block": layers * ev,
                                      "embedding_lookup": st + ev})
    set_launches(kernels, launches, ("small_attention", "small_attention_bwd"))
    lap("train FT unfused")
    lockstep(unfused_lock, tr_c, device, label="lockstep FT unfused",
             cpu_ref=cpu_refs["FT unfused"])
    lap("lockstep FT unfused")
    profile_training("train_ft_unfused", unfused, tr_c, va_c, device,
                     focus={"#2 small_attention": "sa_fwd_kernel",
                            "#3 small_attention_bwd": "sa_bwd_kernel"})
    lap("profile train FT unfused")

    flash, flash_lock, tr_w, va_w = paths["FT flash"]
    say(f"train FT flash: 1000 features (50 categorical, vocab 1000), "
        f"S=1001, the same width, attention_impl flash, batch {FLASH_BATCH}, "
        f"{FLASH_STEPS} steps, {FLASH_VALID_ROWS} valid rows, 1 epoch (chip "
        f"time: one step's attention is ~0.8 TFLOP forward)")
    _, launches = run_training(
        "train FT flash", flash, tr_w, va_w, device, want_tier="resident",
        want_launches=lambda st, ev: {"flash_fwd": layers * (st + ev),
                                      "flash_bwd_dq": layers * st,
                                      "flash_bwd_dkv": layers * st,
                                      "embedding_lookup": st + ev})
    set_launches(kernels, launches, ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"))
    lap("train FT flash")
    lockstep(flash_lock, tr_w, device, label="lockstep FT flash",
             cpu_ref=cpu_refs["FT flash"])
    lap("lockstep FT flash")


# -- phases 14 to 19: Wide&Deep and DeepFM -------------------------------------

# the embedding rungs of bench.py, none cut in width: DeepFM at 100k vocab
# (:510: 30 features, 6 categorical, embedding_dim 16, hidden 100-100 relu,
# bf16, weighted_mse, Adadelta 0.003, batch 32768, 32 batches), its 4M-vocab
# sparse-against-dense pair (:366-398: batch 4096, 8 steps) and the
# 1000-column Wide&Deep (:507: 1000 features, 50 categorical, vocab 1000,
# batch 8192, 16 batches); 65,536 valid rows for the 100k DeepFM
DEEPFM_VOCAB = 100_000
DEEPFM_BATCH = 32768
DEEPFM_TRAIN_ROWS = 32 * DEEPFM_BATCH
DEEPFM_VALID_ROWS = 65_536
BIG_VOCAB = 4_000_000
BIG_VOCAB_BATCH = 4096
BIG_VOCAB_STEPS = 8
WD_BATCH = 8192
WD_TRAIN_ROWS = 16 * WD_BATCH
WD_VALID_ROWS = 8192
# the DeepFM lockstep computes in f32, as the FT ones do: card and CPU then
# differ in summation order only (the lookup gradient's index_add_ adds in
# f32 atomics on the card)
LOCKSTEP_DEEPFM_DTYPE = "float32"


def dlrm_job(model_type: str, schema, batch: int, epochs: int = 1,
             staged: bool = True, sparse: str = "auto"):
    from shifu_tpu_torch.config.schema import (DataConfig, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    return JobConfig(
        schema=schema, data=DataConfig(batch_size=batch, staged=staged),
        model=ModelSpec(model_type=model_type, hidden_nodes=(100, 100),
                        activations=("relu", "relu"), embedding_dim=16,
                        compute_dtype="bfloat16"),
        train=TrainConfig(epochs=epochs, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta",
                                                    learning_rate=0.003),
                          sparse_embedding_update=sparse),
    ).validate()


def deepfm_schema(vocab: int):
    from shifu_tpu_torch.data import synthetic
    return synthetic.make_schema(num_features=30, num_categorical=6,
                                 vocab_size=vocab)


def deepfm_lockstep_path() -> tuple:
    """(job, lockstep job, train, valid) of the DeepFM 100k-vocab rung on
    the per-batch tier, from SEED alone (the process that runs the
    lockstep's CPU half builds the same)."""
    job = dlrm_job("deepfm", deepfm_schema(DEEPFM_VOCAB), DEEPFM_BATCH,
                   staged=False)
    lock = with_batch(job, DEEPFM_BATCH, compute_dtype=LOCKSTEP_DEEPFM_DTYPE)
    return (job, lock, *synthetic_datasets(job.schema, DEEPFM_TRAIN_ROWS,
                                           DEEPFM_VALID_ROWS, SEED + 3))


def sparse_launches(steps: int, evals: int) -> dict:
    """A sparse DeepFM run: one lookup a step and eval batch, one update a
    step for each of its two tables."""
    return {"embedding_lookup": steps + evals, "rows_update": 2 * steps}


def big_vocab_pair(device) -> None:
    """DeepFM at 4M vocab with the sparse update on and off (bench.py's
    `ladder_deepfm_4mvocab_sparse_speedup`): 2 epochs of 4 steps each, the
    resident tier (raw ids through kernel #6 when on); samples/s of epoch
    1 and their ratio, and the seconds `train` spends before its first
    epoch, which building the model on the host takes."""
    import gc
    import torch
    schema = deepfm_schema(BIG_VOCAB)
    steps_per_epoch = BIG_VOCAB_STEPS // 2
    tr, va = synthetic_datasets(schema, steps_per_epoch * BIG_VOCAB_BATCH,
                                BIG_VOCAB_BATCH, SEED + 4)
    rate = {}
    for mode in ("on", "off"):
        job = dlrm_job("deepfm", schema, BIG_VOCAB_BATCH, epochs=2,
                       sparse=mode)
        label = f"train DeepFM 4M vocab sparse {mode}"
        t0 = time.perf_counter()
        res, _ = run_training(
            label, job, tr, va, device, want_tier="resident",
            want_launches=(sparse_launches if mode == "on" else
                           lambda st, ev: {"embedding_lookup": st + ev}))
        wall = time.perf_counter() - t0
        setup = wall - sum(m.epoch_time + m.valid_time for m in res.history)
        last = res.history[-1]
        rate[mode] = steps_per_epoch * BIG_VOCAB_BATCH / last.epoch_time
        say(f"{label}: set-up {setup:.2f} s before epoch 0 (the model built "
            f"on the host: the (6, 4000000, 16) f32 table, 1.54 GB, and the "
            f"(6, 4000000, 1) one drawn by a torch.Generator, then copied to "
            f"the card); epoch 1 {rate[mode]:.1f} samples/s")
        del res
        gc.collect()
        torch.cuda.empty_cache()
    say(f"train DeepFM 4M vocab: sparse on / off samples/s (epoch 1) = "
        f"{rate['on'] / rate['off']:.3f} ({rate['on']:.1f} / "
        f"{rate['off']:.1f})")


def embedding_training_phases(device, tmp: str, kernels: list,
                              cpu_refs: dict) -> None:
    import torch
    from shifu_tpu_torch.data import synthetic
    from shifu_tpu_torch.export.artifact import save_artifact

    job, lock_job, tr, va = deepfm_lockstep_path()
    say(f"train DeepFM: {tr.num_rows} train + {va.num_rows} valid rows, 30 "
        f"features (6 categorical, vocab {DEEPFM_VOCAB}), embedding_dim 16, "
        f"hidden (100, 100) relu, bf16, {job.train.loss}, adadelta 0.003, "
        f"batch {DEEPFM_BATCH}, 1 epoch, per-batch tier with dedup, sparse "
        f"update (auto: vocab >= 100000)")
    torch.cuda.reset_peak_memory_stats(device)
    res, launches = run_training("train DeepFM", job, tr, va, device,
                                 want_tier="batch",
                                 want_launches=sparse_launches)
    peak = torch.cuda.max_memory_allocated(device)
    if res.dedup is None or res.state.table_slots is None:
        fail("train DeepFM: the sparse plan or the dedup did not engage")
    ded = res.dedup
    say(f"train DeepFM: dedup {ded['unique']} unique rows of {ded['cells']} "
        f"id cells in {ded['batches']} batches, ratio "
        f"{ded['unique'] / ded['cells']:.4f}; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB")
    set_launches(kernels, launches, ("embedding_lookup", "rows_update"))
    # the host's share of a step: the dedup of one batch, timed alone on
    # the epoch's batches
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.embed.dedup import attach_dedup
    plan_layout = res.state.model.layout
    batches = list(pipe.batch_iterator(tr, DEEPFM_BATCH,
                                       seed=job.data.shuffle_seed))
    transform = attach_dedup(plan_layout, DEEPFM_VOCAB)
    t0 = time.perf_counter()
    for b in batches:
        transform(b)
    dedup_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    step_ms = res.history[0].epoch_time / len(batches) * 1e3
    say(f"train DeepFM: host dedup {dedup_ms:.3f} ms a batch, of "
        f"{step_ms:.3f} ms a step in the epoch")
    del batches
    lap("train DeepFM")
    feeder_pair("DeepFM", tmp, job, tr, va, device, "batch", sparse_launches,
                tol=1e-6, why="the lookup's backward adds duplicate ids' "
                "gradients with f32 atomics (index_add_ in "
                "ops/embedding.scatter_grad), in no fixed order")
    lap("feeder DeepFM")
    lockstep(lock_job, tr, device, label="lockstep DeepFM",
             cpu_ref=cpu_refs["DeepFM"])
    lap("lockstep DeepFM")

    resident = job.replace(data=dataclasses.replace(job.data, staged=True))
    run_training("train DeepFM resident", resident, tr, va, device,
                 want_tier="resident", want_launches=sparse_launches)
    lap("train DeepFM resident")

    export_dir = save_artifact(res.state.model, job.model, job.schema,
                               f"{tmp}/trained_deepfm")
    served = serve_phase("trained DeepFM", export_dir, job.schema,
                         np.random.default_rng(SEED), device,
                         rows_per_thread=128, n_frames=1)
    report_serve("trained DeepFM", served)
    if served["launches"] != {k: (served["dispatched"]
                                  if k == "embedding_lookup" else 0)
                              for k in served["launches"]}:
        fail(f"trained DeepFM: launches {served['launches']}, expected one "
             f"lookup a batch ({served['dispatched']}) and no other kernel")
    profile_training("train_deepfm", job, tr, va, device,
                     table_lead=(6, DEEPFM_VOCAB))
    del res
    lap("serve trained DeepFM and profile train_deepfm")

    big_vocab_pair(device)
    lap("train DeepFM 4M vocab, sparse on and off")

    wd_schema = synthetic.make_schema(num_features=1000, num_categorical=50,
                                      vocab_size=1000)
    wd = dlrm_job("wide_deep", wd_schema, WD_BATCH)
    tr_w, va_w = synthetic_datasets(wd_schema, WD_TRAIN_ROWS, WD_VALID_ROWS,
                                    SEED + 5)
    say(f"train Wide&Deep: 1000 features (50 categorical, vocab 1000), "
        f"{tr_w.num_rows} train + {va_w.num_rows} valid rows, batch "
        f"{WD_BATCH}, 1 epoch, resident tier, dense update (vocab < 100000)")
    run_training("train Wide&Deep", wd, tr_w, va_w, device,
                 want_tier="resident",
                 want_launches=lambda st, ev: {"embedding_lookup": st + ev})
    lap("train Wide&Deep 1000 columns")


# -- phases 20a to 20d: the flight recorder, FLOPs and MFU ---------------------

# the device kernels each wrapper launches, by a substring of their names in
# a torch.profiler trace (csrc/*.cu's __global__ functions)
KERNEL_SYMBOLS = {"ft_block": ("ft_block_kernel",),
                  "small_attention": ("sa_fwd_kernel",),
                  "small_attention_bwd": ("sa_bwd_kernel",),
                  "int8_matmul": ("panel_kernel", "tiled_kernel"),
                  "embedding_lookup": ("lookup_kernel",),
                  "rows_update": ("rows_update_kernel",),
                  "flash_fwd": ("flash_fwd_kernel",),
                  "flash_bwd_dq": ("flash_dq_kernel",),
                  "flash_bwd_dkv": ("flash_dkv_kernel",)}
# 20a's headline MLP: the full width, depth cut to 10 batches an epoch
FR_TRAIN_ROWS = 10 * TRAIN_BATCH
FR_VALID_ROWS = 65_536
# 20d's anomaly drill: the headline MLP on the per-batch tier, a chunk a
# step, the chaos delay in the step one chunk past anomaly_min_chunks
DRILL_BATCH = 16_384
DRILL_STEPS = 24
DRILL_MIN_CHUNKS = 8
DRILL_DELAY_S = 1.0
# 20c: one step of each trained path, counted on the card and on the CPU
FLOPS_BATCH = 64


def kernel_calls(rollup: dict, kernel: str) -> dict:
    """Calls of `kernel`'s device functions in a rollup, by module."""
    out: dict = {}
    for k in rollup["kernels"]:
        if any(s in k["name"] for s in KERNEL_SYMBOLS[kernel]):
            out[k["module"]] = out.get(k["module"], 0) + k["calls"]
    return out


class WindowLaunches:
    """The launch counters at the start and stop of every flight-recorder
    capture (DeviceProfiler._start_trace / _stop_and_journal wrapped), so a
    window's launches can be held against its rollup."""

    def __init__(self):
        from shifu_tpu_torch.obs import devprof
        self.cls = devprof.DeviceProfiler
        self.orig = (self.cls._start_trace, self.cls._stop_and_journal)
        self.windows: list = []
        start, stop = self.orig
        me = self

        def _start(prof, log_dir, epoch):
            ok = start(prof, log_dir, epoch)
            if ok:
                me.windows.append({"start": read_launches()})
            return ok

        def _stop(prof, log_dir, epoch, trigger, window_s=None):
            if me.windows and "stop" not in me.windows[-1]:
                import torch
                torch.cuda.synchronize()
                me.windows[-1]["stop"] = read_launches()
            return stop(prof, log_dir, epoch, trigger, window_s)

        self.cls._start_trace, self.cls._stop_and_journal = _start, _stop

    def launches(self, i: int = 0) -> dict:
        w = self.windows[i]
        return {k: w["stop"][k] - w["start"][k] for k in w["start"]}

    def close(self) -> None:
        self.cls._start_trace, self.cls._stop_and_journal = self.orig


def check_window(label: str, rollup: dict, launched: dict) -> bool:
    """A device_profile against the launches inside its window: its
    kernels' calls are counted over the whole capture (the window's trace
    rolled up again with no top-K cut), and equal to the launches, or the
    profile lost events; False when a kernel lost more than half of them
    (the caller retakes, as `device_ms` does).  Fails on a share over 1.05
    or kernels longer than the window."""
    from shifu_tpu_torch.obs import tracefmt
    if rollup["device_us_total"] > rollup["window_us"] * rollup["lanes"] \
            * (1 + 1e-6):
        fail(f"{label}: kernels' device time {rollup['device_us_total']} us "
             f"exceeds the window {rollup['window_us']} us x "
             f"{rollup['lanes']} lanes")
    for k in rollup["kernels"]:
        for key in ("flops_frac", "hbm_frac"):
            if k.get(key) is not None and not 0 < k[key] <= 1.05:
                fail(f"{label}: {k['name'][:60]} {key} {k[key]} outside "
                     "(0, 1.05]: a counting fault")
    full = tracefmt.rollup_trace_dir(rollup["trace_dir"], top_k=1 << 30)
    ok = True
    for name, n in launched.items():
        if not n:
            continue
        by_module = kernel_calls(full, name)
        got = sum(by_module.values())
        PROFILE_EVENTS["lost"] += n - got
        say(f"{label}: {name}: {n} launches in the window, {got} calls in "
            f"the capture (by module {by_module}; "
            f"{full['kernel_count']} distinct kernels)")
        ok = ok and 0 <= n - got and 2 * (n - got) <= n
    return ok


def traced_run(label: str, job, train_ds, valid_ds, device, tmp: str,
               name: str) -> tuple:
    """Train `job` with its sinks in `tmp/name`; retake while the profiler
    lost a kernel's events (fail after PROFILE_ATTEMPTS).  Returns (the
    journal's events, the result, the first window's launches)."""
    from shifu_tpu_torch.train.loop import train
    for attempt in range(PROFILE_ATTEMPTS):
        out = os.path.join(tmp, f"{name}-{attempt}")
        configure_obs(out)
        job_a = job.replace(obs=dataclasses.replace(
            job.obs, trace_dir=os.path.join(out, "trace")))
        windows = WindowLaunches()
        try:
            reset_launches()
            res = train(job_a, train_ds, valid_ds, console=lambda ln: None,
                        device=device)
        finally:
            windows.close()
        events = journal(out)
        profiles = [e for e in events if e["kind"] == "device_profile"]
        if not profiles or not windows.windows:
            fail(f"{label}: no device_profile journaled")
        launched = windows.launches(0)
        if check_window(label, profiles[0], launched):
            return events, res, launched
        say(f"{label}: retake {attempt + 1} (the profiler lost events)")
    fail(f"{label}: the profiler lost events in {PROFILE_ATTEMPTS} windows")


def report_flight(label: str, events: list) -> None:
    """The traced epochs' MFU and TFLOP/s, the watermarks, the top kernels;
    fails on a goodput without numbers or an MFU outside (0, 1.05]."""
    for e in events:
        if e["kind"] == "trace_fallback":
            fail(f"{label}: trace_fallback {e}: the profiler failed")
        if e["kind"] == "goodput":
            mfu, tf = e.get("mfu"), e.get("achieved_tflops")
            if mfu is None or tf is None or not 0 < mfu <= 1.05:
                fail(f"{label}: goodput of epoch {e['epoch']} has mfu {mfu} "
                     f"and achieved_tflops {tf}")
            say(f"{label}: epoch {e['epoch']}: mfu {mfu:.6g}, achieved "
                f"{tf:.6g} TFLOP/s of {e['peak_tflops']} (goodput "
                f"{e['goodput_fraction']}, wall {e['wall_s']:.4f} s)")
        if e["kind"] == "hbm_watermark":
            say(f"{label}: epoch {e['epoch']}: hbm_watermark {e['source']}: "
                f"peak {e['peak_bytes'] / 2 ** 30:.3f} GiB, in use "
                f"{e['bytes_in_use'] / 2 ** 30:.3f} GiB of "
                f"{e['bytes_limit'] / 2 ** 30:.3f} GiB")
    for e in events:
        if e["kind"] != "device_profile":
            continue
        say(f"{label}: device_profile epoch {e['epoch']} ({e['trigger']}): "
            f"window {e['window_us'] / 1e3:.3f} ms, device "
            f"{e['device_us_total'] / 1e3:.3f} ms (fraction "
            f"{e['device_fraction']}), {e['kernel_count']} kernels; modules "
            f"{e['modules']}")
        for k in e["kernels"][:8]:
            say(f"{label}:   {k['device_us'] / 1e3:9.3f} ms {k['calls']:6d}x "
                f"{100 * (k['fraction'] or 0):6.2f}%  flops_frac "
                f"{k.get('flops_frac')} hbm_frac {k.get('hbm_frac')} bound "
                f"{k.get('bound')}  {k['name'][:70]}")


def state_and_data_bytes(state, n_rows: int, row_bytes: int) -> int:
    """Bytes the training needs on the card at least: parameters,
    optimizer slots, table slots, and the resident rows."""
    from shifu_tpu_torch.train.loop import _tensor_bytes
    return (_tensor_bytes(state.model.state_dict())
            + _tensor_bytes(state.optimizer.state_dict())
            + _tensor_bytes(state.table_slots) + n_rows * row_bytes)


def flight_mlp(device, tmp: str) -> None:
    """20a: the headline MLP, resident tier, 2 epochs, the first traced."""
    import torch
    torch.cuda.reset_peak_memory_stats(device)
    job = headline_job(epochs=2)
    job = job.replace(obs=dataclasses.replace(job.obs, trace_epochs="first",
                                              trace_top_k=64))
    tr, va = synthetic_datasets(job.schema, FR_TRAIN_ROWS, FR_VALID_ROWS,
                                SEED + 20)
    events, res, launched = traced_run("20a MLP", job, tr, va, device, tmp,
                                       "fr_mlp")
    if res.tier != "resident":
        fail(f"20a MLP: trained on the {res.tier!r} tier")
    nb = FR_TRAIN_ROWS // TRAIN_BATCH
    if launched.get("int8_matmul") != nb:
        fail(f"20a MLP: #4 launched {launched} in epoch 0's window, "
             f"expected {nb}")
    # the resident rows: int8 features, u8 targets, the weights elided
    need = state_and_data_bytes(res.state, nb * TRAIN_BATCH,
                                job.schema.feature_count + 1)
    marks = [e for e in events if e["kind"] == "hbm_watermark"]
    if len(marks) != 2:
        fail(f"20a MLP: {len(marks)} hbm_watermark events, expected 2")
    for m in marks:
        if m["source"] != "memory_stats" or not (
                need <= m["peak_bytes"] <= m["bytes_limit"]):
            fail(f"20a MLP: hbm_watermark {m}: expected memory_stats with "
                 f"{need} <= peak <= limit")
    say(f"20a MLP: the state and the resident rows need {need} bytes")
    report_flight("20a MLP", events)


def flight_ft(device, tmp: str) -> None:
    """20b: the fused FT-Transformer at full width, one epoch traced.  On
    the serving schema (24 numeric + 6 categorical, vocab 1000) with
    dropout 0, so #1 and #5 both run (phase 11's 30 numeric features give
    no lookup)."""
    from shifu_tpu_torch.data import synthetic
    schema = synthetic.make_schema(num_features=30, num_categorical=6,
                                   vocab_size=1000)
    job = ft_job(schema, FT_BATCH, 1)
    job = job.replace(obs=dataclasses.replace(job.obs, trace_epochs="first",
                                              trace_top_k=64))
    tr, va = synthetic_datasets(schema, 8 * FT_BATCH, FT_BATCH, SEED + 21)
    events, _res, launched = traced_run("20b FT fused", job, tr, va, device,
                                        tmp, "fr_ft")
    for name in ("ft_block", "embedding_lookup"):
        if not launched.get(name):
            fail(f"20b FT fused: {name} did not launch in the window "
                 f"({launched})")
    report_flight("20b FT fused", events)


def count_step(job, dev, rows) -> dict:
    """obs.flops' count of one train step of `job` on `dev` at the first
    batch of `rows` (as the loop casts it), from the job's init."""
    from shifu_tpu_torch.obs import flops
    from shifu_tpu_torch.train.loop import init_state, to_device
    from shifu_tpu_torch.train.step import _train_step_fn
    (batch,) = lockstep_batches(job, rows, 1)
    state = init_state(job, job.schema.feature_count, dev)
    _, got = flops.count(_train_step_fn(job), state,
                         to_device(batch, job, dev))
    return got


# 20c's bytes: autograd steals a gradient into .grad, or clones it (an
# empty + copy_ the count sees), by the gradient's reference count at the
# time, which moves from one run to the next (the fused block's recompute
# backward showed it on the CPU alone); the FLOPs do not move
FLOPS_BYTES_RTOL = 5e-3


def flops_equal(device) -> None:
    """20c: one step of every trained path counted on the card and on the
    CPU at FLOPS_BATCH rows: the FLOPs must be equal, the bytes within
    FLOPS_BYTES_RTOL, and the MLP's FLOPs its closed form."""
    from shifu_tpu_torch.data import synthetic
    deepfm = dlrm_job("deepfm", deepfm_schema(DEEPFM_VOCAB), FLOPS_BATCH,
                      staged=False)
    wd_schema = synthetic.make_schema(num_features=1000, num_categorical=50,
                                      vocab_size=1000)
    paths = {"MLP": headline_job()}
    for label, (job, *_rest) in ft_paths_jobs().items():
        paths[label] = job
    paths["DeepFM sparse"] = deepfm
    paths["Wide&Deep"] = dlrm_job("wide_deep", wd_schema, FLOPS_BATCH)
    for label, job in paths.items():
        job = with_batch(job, FLOPS_BATCH)
        rows, _ = synthetic_datasets(job.schema, FLOPS_BATCH, 8, SEED + 22)
        card, cpu = count_step(job, device, rows), count_step(job, "cpu",
                                                              rows)
        db = abs(card["bytes_accessed"] - cpu["bytes_accessed"])
        if (card["flops"] != cpu["flops"]
                or card["exponentials"] != cpu["exponentials"]
                or db > FLOPS_BYTES_RTOL * cpu["bytes_accessed"]):
            fail(f"20c {label}: the card counts {card}, the CPU {cpu}")
        say(f"20c {label}: one step at {FLOPS_BATCH} rows: "
            f"{card['flops']:.6g} FLOPs on the card and on the CPU; bytes "
            f"{card['bytes_accessed']:.6g} and {cpu['bytes_accessed']:.6g}")
        if label == "MLP":
            widths = (job.schema.feature_count, *job.model.hidden_nodes, 1)
            later = sum(a * b for a, b in zip(widths[1:], widths[2:]))
            closed = (6 * later + 4 * widths[0] * widths[1]) * FLOPS_BATCH
            if card["flops"] != closed:
                fail(f"20c MLP: {card['flops']} FLOPs, the closed form "
                     f"(6 x the later layers + 4 x layer 0, which takes no "
                     f"dX) x {FLOPS_BATCH} = {closed}")


def ft_paths_jobs() -> dict:
    """The three FT training paths' jobs (ft_paths without its data)."""
    from shifu_tpu_torch.data import synthetic
    wide = synthetic.make_schema(num_features=1000, num_categorical=50,
                                 vocab_size=1000)
    return {"FT fused": (ft_job(synthetic.make_schema(num_features=30),
                                FT_BATCH, FT_EPOCHS),),
            "FT unfused": (ft_unfused_job(),),
            "FT flash": (ft_job(wide, FLASH_BATCH, 1,
                                attention_impl="flash"),)}


def anomaly_drill(device, tmp: str) -> None:
    """20d: a chaos delay inside the step of the chunk one past
    anomaly_min_chunks journals one anomaly and a device_profile with
    trigger "anomaly" (a one-shot capture of the next chunk)."""
    from shifu_tpu_torch import chaos
    from shifu_tpu_torch.train import loop as loop_mod

    job = headline_job(epochs=1)
    job = job.replace(
        data=dataclasses.replace(job.data, batch_size=DRILL_BATCH,
                                 staged=False),
        # tracing on, but no scheduled window: only the one-shot fires; a
        # chunk must run 3x the median (a traced chunk does not)
        obs=dataclasses.replace(job.obs, trace_epochs="99",
                                anomaly_min_chunks=DRILL_MIN_CHUNKS,
                                anomaly_min_ratio=2.0))
    tr, va = synthetic_datasets(job.schema, DRILL_STEPS * DRILL_BATCH,
                                DRILL_BATCH, SEED + 23)
    out = os.path.join(tmp, "drill_anomaly")
    configure_obs(out)
    job = job.replace(obs=dataclasses.replace(
        job.obs, trace_dir=os.path.join(out, "trace")))
    orig = loop_mod.make_train_step

    def delayed(j):
        step = orig(j)

        def run(state, batch):
            chaos.maybe_fail("chip_smoke.step")
            return step(state, batch)
        return run

    chaos.configure(chaos.parse_plan({"faults": [
        {"site": "chip_smoke.step", "at_call": DRILL_MIN_CHUNKS + 1,
         "action": "delay", "delay_s": DRILL_DELAY_S}]}))
    loop_mod.make_train_step = delayed
    try:
        loop_mod.train(job, tr, va, console=lambda ln: None, device=device)
    finally:
        loop_mod.make_train_step = orig
        chaos.reset_for_tests()
    events = journal(out)
    anomalies = [e for e in events if e["kind"] == "anomaly"]
    shots = [e for e in events if e["kind"] == "device_profile"]
    if len(anomalies) != 1 or anomalies[0]["chunk"] != DRILL_MIN_CHUNKS + 1:
        fail(f"20d anomaly: {len(anomalies)} anomaly events "
             f"{[(a['chunk'], a['step_s']) for a in anomalies]}, expected "
             f"one at chunk {DRILL_MIN_CHUNKS + 1}")
    if len(shots) != 1 or shots[0]["trigger"] != "anomaly":
        fail(f"20d anomaly: device_profile events {[(s['trigger']) for s in shots]}, "
             "expected one with trigger 'anomaly'")
    a = anomalies[0]
    say(f"20d anomaly: chunk {a['chunk']} step {a['step_s']} s against the "
        f"median {a['median_s']} s (z {a['zscore']}); one-shot "
        f"device_profile of the next chunk: {shots[0]['kernel_count']} "
        f"kernels, {shots[0]['device_us_total'] / 1e3:.3f} ms on the card")


def trace_fault_drill(device, tmp: str) -> None:
    """20d: an `obs.trace` fault journals trace_fallback; the losses are
    bitwise those of an untraced twin."""
    from shifu_tpu_torch import chaos
    from shifu_tpu_torch.train.loop import train

    job = headline_job(epochs=2)
    tr, va = synthetic_datasets(job.schema, 4 * TRAIN_BATCH, FR_VALID_ROWS,
                                SEED + 24)
    losses = {}
    for name, spec in (("faulted", "first"), ("untraced", "off")):
        out = os.path.join(tmp, f"drill_trace_{name}")
        configure_obs(out)
        if name == "faulted":
            chaos.configure(chaos.parse_plan({"faults": [
                {"site": "obs.trace", "every": 1, "action": "raise"}]}))
        try:
            res = train(job.replace(obs=dataclasses.replace(
                job.obs, trace_epochs=spec,
                trace_dir=os.path.join(out, "trace"))), tr, va,
                console=lambda ln: None, device=device)
        finally:
            chaos.reset_for_tests()
        losses[name] = [m.train_error for m in res.history]
        events = journal(out)
        falls = [e for e in events if e["kind"] == "trace_fallback"]
        if name == "faulted" and (len(falls) != 1
                                  or falls[0]["stage"] != "start"):
            fail(f"20d trace fault: trace_fallback events {falls}, expected "
                 "one at stage 'start'")
        if any(e["kind"] == "device_profile" for e in events):
            fail(f"20d trace fault ({name}): a device_profile was journaled")
    if losses["faulted"] != losses["untraced"]:
        fail(f"20d trace fault: losses {losses['faulted']} differ from the "
             f"untraced twin's {losses['untraced']}")
    say(f"20d trace fault: trace_fallback at stage start; losses "
        f"{losses['faulted']} bitwise the untraced twin's")


def flight_recorder_phases(device, tmp: str) -> None:
    flight_mlp(device, tmp)
    lap("20a flight recorder, MLP")
    flight_ft(device, tmp)
    lap("20b flight recorder, FT fused")
    flops_equal(device)
    lap("20c FLOPs on the card and the CPU")
    anomaly_drill(device, tmp)
    trace_fault_drill(device, tmp)
    lap("20d flight recorder drills")


# -- phases 21a to 21d: multitask and MoE, the wire path, drift and SLO --------

# the multitask and MoE rungs of bench.py (:511-518): 30 features, hidden
# (100, 100) relu, bf16, batch 32768, 32 batches, weighted_mse, Adadelta
# 0.003; two heads for multitask (two targets), 8 experts for the MoE
LADDER_BATCH = 32768
LADDER_TRAIN_ROWS = 32 * LADDER_BATCH
LADDER_VALID_ROWS = 65_536
LADDER_EPOCHS = 2
LADDER_LOCKSTEP_BATCH = 8192
PROBE_ROWS = 4096
# 21c: the fixed offered rates (requests/s) and seconds of each mode; the
# socket's senders run in a process of their own, off the server's GIL
WIRE_INPROC_RATE = 20_000.0
WIRE_SOCKET_RATE = 1_000.0
WIRE_SECONDS = 10.0
WIRE_SENDERS = 8
# 21d: the drift and SLO drills' windows, rows and shifted feature
DRIFT_FAST_S = 1.0
DRIFT_SLOW_S = 2.0
DRIFT_FRAME_ROWS = 1024
DRIFT_HEALTHY_S = 2.5
DRIFT_SHIFTED_S = 3.0
DRIFT_FEATURE = 7
DRIFT_FEEDBACK_ROWS = 65_536
DRIFT_TRAFFIC_ROWS = 262_144
SLO_DRILL_S = 8.0
# the p99 targets (ms) an SLO objective may take: bounds of the serving
# latency buckets, so the violation count is bucket-exact
SLO_TARGETS_MS = (0.25, 0.5, 1.0, 2.5)


def ladder_job(model_type: str, batch: int = 0):
    from shifu_tpu_torch.config.schema import (DataConfig, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    from shifu_tpu_torch.data import synthetic
    heads = 2 if model_type == "multitask" else 1
    spec = ModelSpec(model_type=model_type, hidden_nodes=(100, 100),
                     activations=("relu", "relu"), compute_dtype="bfloat16",
                     num_heads=heads,
                     head_names=tuple(f"shifu_output_{h}"
                                      for h in range(heads)),
                     num_experts=8 if model_type == "moe_mlp" else 4)
    return JobConfig(
        schema=synthetic.make_schema(num_features=30, num_targets=heads),
        data=DataConfig(batch_size=batch or LADDER_BATCH, wire_dtype="int8"),
        model=spec,
        train=TrainConfig(epochs=LADDER_EPOCHS, loss="weighted_mse",
                          optimizer=OptimizerConfig(name="adadelta",
                                                    learning_rate=0.003)),
    ).validate()


def score_three_ways(label: str, export_dir: str, rows: np.ndarray,
                     heads: int, device) -> None:
    """The probe rows through TorchScorer on the card, the numpy op-list
    Scorer on the host and the daemon on the card (single-row submits and
    one frame): (N, H) everywhere, all within SERVE_ATOL of one another on
    every head."""
    from shifu_tpu_torch.config.schema import ServingConfig
    from shifu_tpu_torch.export.scorer import Scorer, TorchScorer
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    card = TorchScorer(export_dir, device=device).compute_batch(rows)
    host = Scorer(export_dir).compute_batch(rows)
    daemon = ScoringDaemon(export_dir, config=ServingConfig(
        report_every_s=0.0), device=device).start()
    try:
        futs = [daemon.submit(r) for r in rows[:256]]
        singles = np.stack([f.result(timeout=120) for f in futs])
        frame = daemon.score_batch(rows)
    finally:
        daemon.stop()
    outs = {"TorchScorer": card, "numpy Scorer": host, "daemon frame": frame,
            "daemon rows": singles}
    for name, out in outs.items():
        n = 256 if name == "daemon rows" else rows.shape[0]
        if out.shape != (n, heads) or not np.isfinite(out).all():
            fail(f"{label}: {name} scores have shape {out.shape} (want "
                 f"({n}, {heads})) or are not finite")
    worst = 0.0
    for a in outs:
        for b in outs:
            n = min(outs[a].shape[0], outs[b].shape[0])
            worst = max(worst, float(np.abs(outs[a][:n] - outs[b][:n]).max()))
    if worst > SERVE_ATOL:
        fail(f"{label}: the three scorers disagree by {worst:.3e} > "
             f"{SERVE_ATOL}")
    say(f"{label}: {rows.shape[0]} probe rows scored by TorchScorer on the "
        f"card, the numpy op-list Scorer and the daemon ({heads} heads): "
        f"max pairwise |diff| {worst:.3e} (tol {SERVE_ATOL:g})")


def ladder_phase(label: str, model_type: str, device, tmp: str) -> None:
    """21a / 21b: the rung trained 2 epochs on the resident tier (no
    kernel on its path), the 8-step lockstep, one step's FLOPs on the
    card and the CPU, the artifact scored three ways."""
    from shifu_tpu_torch.export.artifact import save_artifact
    job = ladder_job(model_type)
    t0 = time.perf_counter()
    train_ds, valid_ds = synthetic_datasets(job.schema, LADDER_TRAIN_ROWS,
                                            LADDER_VALID_ROWS, SEED + 40)
    say(f"{label}: {train_ds.num_rows} + {valid_ds.num_rows} rows made in "
        f"{time.perf_counter() - t0:.2f} s; {model_type}, hidden "
        f"{job.model.hidden_nodes} relu, {job.model.num_heads} heads, "
        f"{job.model.num_experts if model_type == 'moe_mlp' else 0} "
        f"experts, bf16, batch {job.data.batch_size}, wire int8")
    res, _ = run_training(label, job, train_ds, valid_ds, device,
                          want_tier="resident",
                          want_launches=lambda steps, evals: {})
    lockstep(with_batch(job, LADDER_LOCKSTEP_BATCH), train_ds, device,
             label=f"{label} lockstep")
    small = with_batch(job, FLOPS_BATCH)
    rows, _ = synthetic_datasets(small.schema, FLOPS_BATCH, 8, SEED + 41)
    card, cpu = count_step(small, device, rows), count_step(small, "cpu",
                                                            rows)
    if card["flops"] != cpu["flops"] or card["flops"] <= 0:
        fail(f"{label}: one step counts {card['flops']} FLOPs on the card, "
             f"{cpu['flops']} on the CPU")
    say(f"{label}: one step at {FLOPS_BATCH} rows: {card['flops']:.6g} "
        "FLOPs on the card and on the CPU")
    out = save_artifact(res.state.model, job.model, job.schema,
                        f"{tmp}/{model_type}",
                        baseline_profile=res.baseline_profile)
    score_three_ways(label, out, valid_ds.features[:PROBE_ROWS],
                     job.model.num_heads, device)


def serve_in_thread(export_dir: str, config, device):
    """`serve_forever` on a thread of this process; returns (port, stop
    event, thread, exit codes)."""
    from shifu_tpu_torch.runtime.serve import serve_forever
    lines: list = []
    stop = threading.Event()
    rc: list = []
    th = threading.Thread(target=lambda: rc.append(serve_forever(
        export_dir, config, echo=lines.append, device=device,
        stop_event=stop)), daemon=True, name="serve-forever")
    th.start()
    t_end = time.monotonic() + 120
    while not lines and th.is_alive() and time.monotonic() < t_end:
        time.sleep(0.02)
    if not lines:
        fail("21c: serve_forever did not start within 120 s")
    say(f"21c: {lines[0]}")
    port = int(lines[0].split(" on ")[1].split()[0].rsplit(":", 1)[1])
    return port, stop, th, rc


def socket_loadtest(port: int, **kw) -> dict:
    """21c's socket loadtest, in a spawned process: its senders' threads
    hold that process's GIL, not the server's."""
    from shifu_tpu_torch.runtime import loadtest
    return loadtest.run_loadtest(connect=f"127.0.0.1:{port}", **kw)


def check_ft_launches(label: str, launches: dict, dispatched: int,
                      layers: int) -> None:
    want = {"ft_block": layers * dispatched, "embedding_lookup": dispatched}
    if dispatched <= 0 or launches != {k: want.get(k, 0) for k in launches}:
        fail(f"{label}: launches {launches}, expected {want} ({dispatched} "
             "batches dispatched) and no other kernel")


def report_load(label: str, rep: dict, smi_line: str) -> None:
    if rep["errors"] or rep["rejected"] or not rep["completed"]:
        fail(f"{label}: {rep['errors']} errors, {rep['rejected']} rejected, "
             f"{rep['completed']} completed")
    stages = rep.get("stages") or {}
    say(f"{label}: offered {rep['offered_rate']:.1f}/s for "
        f"{rep['duration_s']} s, {rep['senders']} senders: "
        f"{rep['completed']} rows, achieved "
        f"{rep['achieved_scores_per_sec']} rows/s, exact p50 "
        f"{rep['p50_ms']} ms p99 {rep['p99_ms']} ms max {rep['max_ms']} ms, "
        f"0 errors; stages mean/p99 ms "
        + ", ".join(f"{s} {v['mean_ms']}/{v['p99_ms']}"
                    for s, v in stages.items())
        + f"; {smi_line}")


def wire_phase(fused_dir: str, device, smi_line: str) -> dict:
    """21c: phase 4's fused FT artifact served on the card; the loadtest
    in process (the daemon's on_batch) and over the socket to
    serve_forever's wire server from a spawned process (ended before 21d's
    profile); #1 and #5 counted in each; the probe rows over the wire
    against the CPU scorer.  Returns the in-process report."""
    from shifu_tpu_torch.config.schema import ServingConfig
    from shifu_tpu_torch.export.scorer import TorchScorer
    from shifu_tpu_torch.runtime import loadtest, serve_wire
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    layers = ft_serving_spec().num_layers
    cfg = ServingConfig(report_every_s=0.0)
    daemon = ScoringDaemon(fused_dir, config=cfg, device=device).start()
    try:
        reset_launches()
        inproc = loadtest.run_loadtest(daemon=daemon, rate=WIRE_INPROC_RATE,
                                       duration=WIRE_SECONDS,
                                       senders=2, seed=SEED)
        launches = read_launches()
        st = daemon.stats()
    finally:
        daemon.stop()
    check_ft_launches("21c in-process", launches,
                      st["batches"] + st["direct_batches"], layers)
    report_load("21c in-process", inproc, smi_line)
    say(f"21c in-process: launches {launches}")

    port, stop, th, rc = serve_in_thread(
        fused_dir, ServingConfig(port=0, report_every_s=0.0), device)
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        pool.apply(time.sleep, (0,))  # the child's start-up, off the clock
        reset_launches()
        sock = pool.apply_async(socket_loadtest, (port,), dict(
            rate=WIRE_SOCKET_RATE, duration=WIRE_SECONDS,
            senders=WIRE_SENDERS, seed=SEED + 1)).get(
                timeout=WIRE_SECONDS + 300)
        pool.close()
        pool.join()
        with serve_wire.ServeClient("127.0.0.1", port, timeout=120) as c:
            st = c.stats()
            launches = read_launches()
            probe = make_rows(PROBE_ROWS, serving_schema(),
                              np.random.default_rng(SEED + 42))
            got = c.score_rows(probe, dtype=serve_wire.DTYPE_F32)
    finally:
        pool.terminate()
        stop.set()
        th.join(timeout=120)
    if rc != [0]:
        fail(f"21c: serve_forever returned {rc}")
    check_ft_launches("21c socket", launches,
                      st["batches"] + st["direct_batches"], layers)
    report_load("21c socket", sock, smi_line)
    want = TorchScorer(fused_dir, device="cpu").compute_batch(probe)
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    if err > SERVE_ATOL:
        fail(f"21c: wire scores vs CPU: shape {got.shape}, max |diff| "
             f"{err:.3e} > {SERVE_ATOL}")
    say(f"21c socket: launches {launches}; {PROBE_ROWS} probe rows in one "
        f"f32 frame over the wire vs the CPU scorer: max |diff| {err:.3e} "
        f"(tol {SERVE_ATOL:g})")
    return inproc


def drift_phase(export_dir: str, job, device, tmp: str) -> None:
    """21d drift: the trained headline MLP (its baseline_profile.json
    from phase 9) served with drift on; training-distribution frames,
    then frames with feature DRIFT_FEATURE shifted by 3 sigma: exactly
    one feature_psi alert, naming that feature alone; labelled feedback
    on held-out rows gives the live AUC `evaluate` gives on them."""
    import torch
    from shifu_tpu_torch.config.schema import DriftConfig, ServingConfig
    from shifu_tpu_torch.export.artifact import (load_artifact,
                                                 params_from_jax)
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    from shifu_tpu_torch.train.loop import evaluate, init_state
    from shifu_tpu_torch.train.step import make_eval_step
    obs_dir = f"{tmp}/drift_obs"
    configure_obs(obs_dir)
    if not os.path.exists(os.path.join(export_dir, "baseline_profile.json")):
        fail("21d: the trained artifact carries no baseline_profile.json")
    traffic, held = synthetic_datasets(job.schema, DRIFT_TRAFFIC_ROWS,
                                       DRIFT_FEEDBACK_ROWS, SEED + 43)
    cfg = ServingConfig(report_every_s=0.0, drift=DriftConfig(
        fast_window_s=DRIFT_FAST_S, slow_window_s=DRIFT_SLOW_S,
        min_rows=200, psi_threshold=0.25, score_kl_threshold=0.0))
    daemon = ScoringDaemon(export_dir, config=cfg, device=device).start()
    rng = np.random.default_rng(SEED + 44)
    feats = traffic.features
    try:
        for shifted, seconds in ((False, DRIFT_HEALTHY_S),
                                 (True, DRIFT_SHIFTED_S)):
            t_end = time.monotonic() + seconds
            while time.monotonic() < t_end:
                x = feats[rng.integers(0, feats.shape[0], DRIFT_FRAME_ROWS)]
                if shifted:
                    x = x.copy()
                    x[:, DRIFT_FEATURE] += 3.0
                daemon.score_batch(x)
                time.sleep(0.01)
            if not shifted:
                healthy = [e for e in journal(obs_dir)
                           if e["kind"] == "drift_alert"]
        scores = daemon.score_batch(held.features)[:, 0]
        daemon.feedback(scores, held.target[:, 0], held.weight[:, 0])
        daemon.drift_flush()
        state_d = daemon.stats()["drift"]
    finally:
        daemon.stop()
    events = journal(obs_dir)
    fired = [e for e in events if e["kind"] == "drift_alert"
             and e["state"] == "firing"]
    names = [[f["feature"] for f in e.get("features", [])] for e in fired]
    want_name = f"f{DRIFT_FEATURE}"
    if healthy or [e["objective"] for e in fired] != ["feature_psi"] \
            or names != [[want_name]]:
        fail(f"21d drift: alerts on healthy traffic {healthy}; firing "
             f"{[(e['objective'], n) for e, n in zip(fired, names)]}, "
             f"expected one feature_psi alert naming {want_name} alone")
    state = init_state(job, job.schema.feature_count, device)
    state.model.load_state_dict(params_from_jax(
        load_artifact(export_dir).weights, state.model))
    _, auc = evaluate(state, held, job, make_eval_step(job),
                      torch.device(device))
    reports = [e for e in events if e["kind"] == "drift_report"]
    live = reports[-1]["auc_live"] if reports else None
    if live is None or abs(live - auc) > 0.02:
        fail(f"21d drift: live AUC from feedback {live}, evaluate's "
             f"{auc:.6f}: more than 0.02 apart")
    ev = fired[0]["features"][0]
    say(f"21d drift: healthy traffic for {DRIFT_HEALTHY_S} s, then "
        f"{want_name} shifted by 3 sigma for {DRIFT_SHIFTED_S} s (frames of "
        f"{DRIFT_FRAME_ROWS} rows; windows {DRIFT_FAST_S}/{DRIFT_SLOW_S} s): "
        f"one feature_psi alert on {want_name} alone, psi fast "
        f"{ev['psi_fast']} slow {ev['psi_slow']}; live AUC from "
        f"{DRIFT_FEEDBACK_ROWS} labelled rows {live:.6f}, evaluate "
        f"{auc:.6f} (tol 0.02); drift state rows {state_d['rows']}")


def slo_phase(export_dir: str, p99_ms: float, device, tmp: str) -> None:
    """21d SLO: the same artifact with a p99 objective under 21c's
    measured p99; single-row traffic from 4 threads until the alert's
    one-shot trace lands: one firing p99 slo_alert and one
    device_profile with trigger "slo" that holds the card's device events
    of the dispatch's range, after at most MAX_CAPTURES captures (each
    empty capture of the card journals a trace_fallback and is retaken on
    the next dispatch)."""
    from shifu_tpu_torch.config.schema import ServingConfig
    from shifu_tpu_torch.obs.slo import ServeTraceTrigger
    from shifu_tpu_torch.runtime.serve import ScoringDaemon
    obs_dir = f"{tmp}/slo_obs"
    configure_obs(obs_dir)
    below = [t for t in SLO_TARGETS_MS if t < p99_ms and t <= 1.0]
    if not below:
        fail(f"21d SLO: 21c's p99 {p99_ms} ms is under every target")
    target = below[-1]
    cfg = ServingConfig(report_every_s=0.0, slo_p99_ms=target,
                        slo_fast_window_s=0.5, slo_slow_window_s=1.0,
                        slo_burn_threshold=2.0)
    rows = np.random.default_rng(SEED + 45).normal(
        size=(4096, 30)).astype(np.float32)
    daemon = ScoringDaemon(export_dir, config=cfg, device=device).start()
    stop = threading.Event()

    def sender(k: int) -> None:
        i = k
        while not stop.is_set():
            daemon.score(rows[i % 4096], timeout=60)
            i += 4

    threads = [threading.Thread(target=sender, args=(k,), daemon=True)
               for k in range(4)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        while time.perf_counter() - t0 < SLO_DRILL_S:
            if any(e["kind"] == "device_profile"
                   for e in journal(obs_dir)):
                break
            time.sleep(0.1)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        time.sleep(1.0)  # the trace's parse and journal finish off-path
        stats = daemon.stats()
    finally:
        stop.set()
        daemon.stop()
    events = journal(obs_dir)
    alerts = [e for e in events if e["kind"] == "slo_alert"
              and e["state"] == "firing"]
    profs = [e for e in events if e["kind"] == "device_profile"]
    retakes = [e for e in events if e["kind"] == "trace_fallback"]
    if [a["objective"] for a in alerts] != ["p99_latency"] \
            or [p.get("trigger") for p in profs] != ["slo"]:
        fail(f"21d SLO: firing alerts {alerts}, device_profiles "
             f"{[p.get('trigger') for p in profs]}, trace_fallback events "
             f"{retakes}: expected one p99 alert and one slo-triggered "
             "profile")
    p = profs[0]
    # a capture of the card rolls up its device events only (kernels and
    # copies, never host ops), attributed to the dispatch's range
    if not p.get("kernel_count") or "serve_dispatch" not in (
            p.get("modules") or {}):
        fail(f"21d SLO: the slo profile holds no device event of the "
             f"serve_dispatch range: {p}")
    if [(r["stage"], r.get("attempt")) for r in retakes] \
            != [("parse", n + 1) for n in range(p["attempt"] - 1)]:
        fail(f"21d SLO: trace_fallback events {retakes} before the "
             f"profile's capture {p['attempt']}: expected one empty "
             "capture of the card per retake")
    top = ", ".join(f"{k['name'][:40]} {k['device_us']} us"
                    for k in p["kernels"][:3])
    say(f"21d SLO: p99 objective {target} ms (21c's in-process p99 "
        f"{p99_ms} ms): alert observed p99 "
        f"{alerts[0].get('observed_p99_ms')} ms, burn fast "
        f"{alerts[0]['burn_fast']} slow {alerts[0]['burn_slow']}; "
        f"{stats['requests']} requests, daemon p99 {stats['p99_ms']:.3f} "
        f"ms; one device_profile (trigger slo, capture {p['attempt']} of "
        f"at most {ServeTraceTrigger.MAX_CAPTURES}: {p['attempt'] - 1} "
        f"captures of the card held no device event) of "
        f"{p['kernel_count']} kernels, "
        f"{p['device_us_total']} us on the device: {top}")


def serving_plane_phases(device, tmp: str, smi_line: str) -> None:
    ladder_phase("21a multitask", "multitask", device, tmp)
    lap("21a multitask")
    ladder_phase("21b MoE", "moe_mlp", device, tmp)
    lap("21b MoE")
    inproc = wire_phase(f"{tmp}/fused", device, smi_line)
    lap("21c wire")
    job = headline_job()
    drift_phase(f"{tmp}/trained_mlp", job, device, tmp)
    slo_phase(f"{tmp}/trained_mlp", inproc["p99_ms"], device, tmp)
    lap("21d drift and SLO")

# -- phases 22a to 22c: the scoring tiers and the operator's artifact commands

ENGINE_TIERS = ("numpy", "native", "torch", "export", "aot")
CARD_TIERS = ("torch", "export", "aot")
TIER_REPS = 5           # timed calls of a card tier a round (host: one)
NATIVE_ATOL = 1e-5      # native against numpy, as the demo asserts
COLD_TIMEOUT_S = 300
CLI_SCORE_PARTS = 1     # gzip parts of phase 8's data scored by 22c
CLI_EVAL_PARTS = 2
CLI_LOAD_RATE = 1_000.0
CLI_LOAD_SECONDS = 3.0
EVAL_AUC_ATOL = 1e-3


def tier_launches(label: str, engine: str, launches: dict,
                  per_call: dict) -> None:
    """The torch tiers launch `per_call` on one call; the host engines
    launch nothing."""
    want = per_call if engine in CARD_TIERS else {}
    if launches != {k: want.get(k, 0) for k in launches}:
        fail(f"{label} {engine}: launches {launches}, expected {want} on "
             "one 4096-row call and no other kernel")


def tier_phase(tmp: str, device, smi_line: str) -> dict:
    """22a: three artifacts (phase 4's fused and unfused FT, phase 9's
    trained headline MLP), each scored on PROBE_ROWS rows by every engine
    tier through `load_engine`: the numpy and native engines on the host,
    torch, export and aot on the card.  Native within NATIVE_ATOL of
    numpy, every pair within SERVE_ATOL; the launch counts of one call;
    rows/s of the card tiers over rounds of TIER_REPS calls in the order
    A B C C B A, and each one's enqueue and synced ms on features already
    on the card (`graph_split`).  The fused artifact's pack holds the
    default ladder (22b's), the others' the 4096 rung alone.  Returns the
    fused pack's build seconds and bytes."""
    from shifu_tpu_torch.data import reader, synthetic
    from shifu_tpu_torch.export import aot
    from shifu_tpu_torch.runtime.serve import load_engine
    layers = ft_serving_spec().num_layers
    t0 = time.perf_counter()
    manifest = aot.build_aot_pack(f"{tmp}/fused", aot.default_buckets(),
                                  device=device)
    pack_s = time.perf_counter() - t0
    if manifest is None:
        fail("22b: the AOT pack of the fused FT artifact was not built")
    lib_bytes = sum(os.path.getsize(f"{tmp}/fused/aot/{rel}")
                    for rel in manifest["libraries"].values())
    pack = {"seconds": pack_s, "bytes": aot.pack_bytes(f"{tmp}/fused"),
            "buckets": manifest["buckets"],
            "libraries": sorted(manifest["libraries"])}
    if device.type == "cuda" and pack["libraries"] != ["embedding_lookup",
                                                       "ft_block"]:
        fail(f"22b: the fused pack carries {pack['libraries']}, expected "
             "the libraries of #1 and #5")
    say(f"22b pack: the fused FT artifact's AOT pack at the default ladder "
        f"{pack['buckets']} built in {pack_s:.2f} s, {pack['bytes']} bytes: "
        f"the {pack['libraries']} libraries {lib_bytes}, the programs and "
        f"the manifest {pack['bytes'] - lib_bytes}; {smi_line}")
    rng = np.random.default_rng(SEED + 50)
    ft_rows = make_rows(PROBE_ROWS, serving_schema(), rng)
    mlp_schema = headline_job().schema
    mlp_rows = reader.project_columns(synthetic.make_rows(
        PROBE_ROWS, mlp_schema, seed=SEED + 51), mlp_schema)["features"]
    arts = (("22a fused FT", "fused", ft_rows,
             {"ft_block": layers, "embedding_lookup": 1}),
            ("22a unfused FT", "unfused", ft_rows,
             {"small_attention": layers, "embedding_lookup": 1}),
            ("22a trained MLP", "trained_mlp", mlp_rows, {}))
    for label, name, rows, per_call in arts:
        d = f"{tmp}/{name}"
        if name != "fused" and aot.build_aot_pack(
                d, (PROBE_ROWS,), device=device) is None:
            fail(f"{label}: the AOT pack was not built")
        outs, rates, card = {}, {}, {}
        for engine in ENGINE_TIERS:
            scorer = load_engine(d, engine, device=device)
            if scorer.engine != engine:
                fail(f"{label}: load_engine({engine!r}) gave the "
                     f"{scorer.engine!r} engine")
            on_card = engine in CARD_TIERS
            if on_card:
                scorer.compute_batch(rows)  # warm: first-call set-up
                card[engine] = scorer
            reset_launches()
            t1 = time.perf_counter()
            out = scorer.compute_batch(rows)  # returns host arrays: synced
            # the host engines take seconds on the FT: timed once
            rates[engine] = PROBE_ROWS / (time.perf_counter() - t1)
            tier_launches(label, engine, read_launches(), per_call)
            if out.shape != (PROBE_ROWS, 1) or not np.isfinite(out).all():
                fail(f"{label} {engine}: scores of shape {out.shape}, or "
                     "not finite")
            outs[engine] = out
        # the card tiers timed in rounds A B C C B A, so that no tier owes
        # its rate to its place in the order
        rounds: dict = {e: [] for e in card}
        for engine in [*card, *reversed(card)]:
            t1 = time.perf_counter()
            for _ in range(TIER_REPS):
                card[engine].compute_batch(rows)
            rounds[engine].append(
                PROBE_ROWS * TIER_REPS / (time.perf_counter() - t1))
        rates.update({e: sum(r) / len(r) for e, r in rounds.items()})
        split = {e: graph_split(e, s, rows) for e, s in card.items()} \
            if device.type == "cuda" else {}
        native_err = float(np.abs(outs["native"] - outs["numpy"]).max())
        worst = max(float(np.abs(outs[a] - outs[b]).max())
                    for a in outs for b in outs)
        if native_err > NATIVE_ATOL or worst > SERVE_ATOL:
            fail(f"{label}: native against numpy {native_err:.3e} (tol "
                 f"{NATIVE_ATOL:g}), worst pair {worst:.3e} (tol "
                 f"{SERVE_ATOL:g})")
        say(f"{label}: {PROBE_ROWS} rows through {', '.join(ENGINE_TIERS)}: "
            f"native vs numpy {native_err:.3e} (tol {NATIVE_ATOL:g}), max "
            f"pairwise {worst:.3e} (tol {SERVE_ATOL:g}); launches of one "
            f"call on the card tiers {per_call or 'none'}; rows/s at "
            f"{PROBE_ROWS}-row batches "
            + ", ".join(f"{e} {r:.1f}" for e, r in rates.items())
            + " (card tiers: the mean of rounds "
            + ", ".join(f"{e} {'/'.join(f'{r:.1f}' for r in v)}"
                        for e, v in rounds.items())
            + "); a call on features already on the card, enqueue / "
            "synced ms: "
            + ", ".join(f"{e} {q:.3f} / {t:.3f}"
                        for e, (q, t) in split.items())
            + f"; {smi_line}")
    return pack


def device_call(engine: str, scorer):
    """The card tier's scoring graph on features already on the card,
    without the copies in and out: the model and its sigmoid (torch), the
    exported program (export), the 4096 rung's program on the pack's
    weights (aot)."""
    import functools

    import torch
    if engine == "torch":
        return lambda xd: torch.sigmoid(scorer.model(xd).float())
    if engine == "export":
        return scorer._module
    return functools.partial(scorer._modules[PROBE_ROWS], scorer._leaves)


def graph_split(engine: str, scorer, rows: np.ndarray) -> tuple:
    """(ms to enqueue one call, ms of one call synced) of `device_call`
    over TIER_REPS calls: the host's share of a 4096-row call against the
    whole."""
    import torch
    fn = device_call(engine, scorer)
    xd = torch.from_numpy(rows).to(scorer.device)
    with torch.inference_mode():
        fn(xd)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TIER_REPS):
            fn(xd)
        enqueue = (time.perf_counter() - t1) / TIER_REPS
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t1) / TIER_REPS
    return enqueue * 1e3, synced * 1e3


def cold_child(engine: str, export_dir: str, out_path: str,
               corrupt_dir: str = "", device: str = "cuda:0") -> None:
    """22b's fresh process: score PROBE_ROWS rows once through `engine`
    on the card and write what happened to `out_path` (the wall clock at
    the first score, the launches, the kernel libraries loaded, or the
    error).  `engine="aot"` then loads `corrupt_dir` (a copy with one
    bucket file damaged) through the aot tier too."""
    import torch
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.ops import _build
    from shifu_tpu_torch.runtime.serve import load_engine
    obs.configure(f"{out_path}.tele")
    rows = make_rows(PROBE_ROWS, serving_schema(),
                     np.random.default_rng(SEED + 52))
    rec: dict = {"engine": engine}
    try:
        scorer = load_engine(export_dir, engine, device=device)
        reset_launches()
        out = scorer.compute_batch(rows)
        rec.update(first_score_wall=time.time(), scorer=scorer.engine,
                   launches=read_launches(),
                   finite=bool(np.isfinite(out).all()))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        rec["error"] = f"{type(e).__name__}: {e}"[:600]
    rec["libraries"] = {n: lib._name for n, lib in _build._libs.items()}
    if corrupt_dir and "error" not in rec:
        reset_launches()
        scorer = load_engine(corrupt_dir, "aot", device=device)
        out = scorer.compute_batch(rows)
        rec["corrupt"] = {"scorer": scorer.engine,
                          "launches": read_launches(),
                          "finite": bool(np.isfinite(out).all())}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    obs.flush()
    with open(out_path, "w") as f:
        json.dump(rec, f)


def start_cold_child(root: str, engine: str, export_dir: str,
                     out_path: str, env: dict, device,
                     corrupt_dir: str = "") -> tuple:
    """`cold_child` in a fresh interpreter with `root` as its working
    directory (the package it imports is `root`'s); returns the process
    and its spawn time."""
    t_spawn = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.cold_child("
         f"{engine!r}, {export_dir!r}, {out_path!r}, {corrupt_dir!r}, "
         f"{str(device)!r})"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, t_spawn, engine, out_path


def join_cold_child(started: tuple) -> dict:
    """The child's record, with the seconds from its spawn to its first
    score."""
    proc, t_spawn, engine, out_path = started
    try:
        _, err = proc.communicate(timeout=COLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"22b {engine}: no exit within {COLD_TIMEOUT_S} s")
    if proc.returncode != 0 or not os.path.exists(out_path):
        fail(f"22b {engine}: the child exited {proc.returncode}: "
             f"{err[-2000:]}")
    with open(out_path) as f:
        rec = json.load(f)
    if "first_score_wall" in rec:
        rec["seconds"] = rec["first_score_wall"] - t_spawn
    return rec


def nvcc_free_env(tmp: str) -> dict:
    """The environment with no nvcc on PATH and CUDA_HOME at an empty
    directory: `ops/_build` can build nothing there."""
    import shutil
    empty = f"{tmp}/no_cuda_home"
    os.makedirs(empty, exist_ok=True)
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env = dict(os.environ, PATH=os.pathsep.join(path), CUDA_HOME=empty)
    old = os.environ.get("PATH")
    try:
        os.environ["PATH"] = env["PATH"]
        if shutil.which("nvcc") is not None:
            fail("22b: nvcc is still on the pruned PATH")
    finally:
        os.environ["PATH"] = old
    return env


def cold_start_phase(tmp: str, device, smi_line: str) -> None:
    """22b: fresh processes to a first score of phase 4's fused FT
    artifact.  torch and export run on this checkout, whose kernels phase
    2 built.  aot runs on a copy of the package with an empty `_build/`
    and no nvcc (`nvcc_free_env`): it must load the pack's libraries and
    launch #1; there the bare artifact's export tier must raise
    KernelBuildError, and a copy of the artifact with a damaged bucket
    file must journal aot_fallback and serve through the export tier on
    the card."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    fused = f"{tmp}/fused"
    copy = f"{tmp}/cold_pkg"
    shutil.copytree(os.path.join(root, "shifu_tpu_torch"),
                    f"{copy}/shifu_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copyfile(os.path.join(root, "chip_smoke.py"),
                    f"{copy}/chip_smoke.py")
    corrupt = f"{tmp}/fused_corrupt"
    shutil.copytree(fused, corrupt)
    bucket = f"{corrupt}/aot/bucket-{PROBE_ROWS:06d}.pt2"
    with open(bucket, "r+b") as f:
        f.seek(os.path.getsize(bucket) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    env = dict(os.environ)
    bare_env = nvcc_free_env(tmp)
    per_call = {"ft_block": ft_serving_spec().num_layers,
                "embedding_lookup": 1}
    # the tiers one after another, each alone on the host but for the
    # bare artifact's child, which shares the first one's start-up
    bare = start_cold_child(copy, "export", fused, f"{tmp}/cold_bare.json",
                            bare_env, device)
    recs = {"torch": join_cold_child(start_cold_child(
        root, "torch", fused, f"{tmp}/cold_torch.json", env, device))}
    bare = join_cold_child(bare)
    recs["export"] = join_cold_child(start_cold_child(
        root, "export", fused, f"{tmp}/cold_export.json", env, device))
    recs["aot"] = join_cold_child(start_cold_child(
        copy, "aot", fused, f"{tmp}/cold_aot.json", bare_env, device,
        corrupt_dir=corrupt))
    for engine, rec in recs.items():
        if rec.get("error") or rec.get("scorer") != engine \
                or not rec.get("finite"):
            fail(f"22b {engine}: {rec}")
        tier_launches("22b", engine, rec["launches"], per_call)
    pack_libs = recs["aot"]["libraries"]
    if sorted(pack_libs) != ["embedding_lookup", "ft_block"] or not all(
            p.startswith(f"{fused}/aot/lib/") for p in pack_libs.values()):
        fail(f"22b aot: the kernel libraries loaded {pack_libs}, expected "
             f"the pack's under {fused}/aot/lib/")
    corrupt_rec = recs["aot"].get("corrupt") or {}
    fallbacks = [e for e in journal(f"{tmp}/cold_aot.json.tele")
                 if e["kind"] == "aot_fallback"]
    if corrupt_rec.get("scorer") != "export" or not corrupt_rec.get(
            "finite") or len(fallbacks) != 1 \
            or "digest mismatch" not in fallbacks[0]["reason"]:
        fail(f"22b aot: the damaged pack gave {corrupt_rec}, fallbacks "
             f"{fallbacks}: expected one aot_fallback (digest mismatch) "
             "and the export tier on the card")
    tier_launches("22b damaged pack", "export", corrupt_rec["launches"],
                  per_call)
    if "KernelBuildError" not in bare.get("error", ""):
        fail(f"22b: the bare artifact without nvcc gave {bare}, expected "
             "KernelBuildError")
    say("22b cold start: seconds from a fresh process's spawn to its first "
        f"{PROBE_ROWS}-row score of the fused FT artifact on the card: "
        + ", ".join(f"{e} {r['seconds']:.2f}" for e, r in recs.items())
        + " (torch and export on this checkout's built kernels; aot on a "
        "copy of the package with an empty _build/ and no nvcc, loading "
        f"{sorted(pack_libs)} from the pack); there the bare artifact "
        f"raised {bare['error'][:80]}...; a damaged bucket journaled "
        f"aot_fallback ({fallbacks[0]['reason'][:60]}) and the export tier "
        f"served on the card with {corrupt_rec['launches']['ft_block']} "
        f"ft_block launches; {smi_line}")


def cli_cmd(args: list, device, **kw) -> subprocess.Popen:
    """`python -m shifu_tpu_torch.launcher.cli <args>` in a child process;
    on the card the default device, as an operator runs it."""
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *args]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    return subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def cli_wait(label: str, proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=COLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{label}: no exit within {COLD_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}: {err[-2000:]}")
    return out


def read_scores(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([[float(v) for v in ln.split("|")] for ln in f
                         if ln.strip()], dtype=np.float64)


def serve_port(label: str, proc: subprocess.Popen) -> int:
    """The port of a `serve --port 0` child, from its first echo line."""
    import select
    deadline = time.monotonic() + COLD_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail(f"{label}: serve exited {proc.returncode}: "
                 f"{proc.stderr.read()[-2000:]}")
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("serve: model="):
                say(f"{label}: {line.strip()}")
                return int(line.split(" on ")[1].split()[0].rsplit(":",
                                                                 1)[1])
    fail(f"{label}: serve printed no address within {COLD_TIMEOUT_S} s")


def default_score(tmp: str, device) -> str:
    """22c's `score` with its default flags (`--engine auto`, `--device
    cuda:0`) on phase 4's fused FT artifact, whose pack 22a built:
    `launcher.cli.main` in this process, the launch counts set to 0 just
    before and read just after.  `auto` on the card must be the aot tier:
    #1 launched once a layer and #5 once on the 4096 rows, the scores those
    of `load_engine(..., "auto")` called directly."""
    from shifu_tpu_torch.launcher import cli
    from shifu_tpu_torch.runtime.serve import load_engine
    fused = f"{tmp}/fused"
    rows = make_rows(PROBE_ROWS, serving_schema(),
                     np.random.default_rng(SEED + 53))
    path, out = f"{tmp}/cli_ft_rows.txt", f"{tmp}/cli_scores_default.txt"
    np.savetxt(path, rows, delimiter="|", fmt="%.9g")
    argv = ["score", "--model", fused, "--input", path, "--output", out]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    reset_launches()
    code = cli.main(argv)
    launches = read_launches()
    if code != 0:
        fail(f"22c score (default flags): exit {code}")
    if device.type == "cuda":
        tier_launches("22c score (default flags)", "aot", launches,
                      {"ft_block": ft_serving_spec().num_layers,
                       "embedding_lookup": 1})
    auto = load_engine(fused, "auto", device=device)
    if device.type == "cuda" and auto.engine != "aot":
        fail(f"22c: auto on the card gave the {auto.engine!r} engine")
    want = auto.compute_batch(rows)
    got = read_scores(out)
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    if err > 1e-6:  # the command writes 6 decimals
        fail(f"22c score (default flags): scores of shape {got.shape} "
             f"against the aot engine's {want.shape}, max |diff| {err:.3e}")
    return (f"score with its default flags on the fused FT artifact: "
            f"launches {launches}, within {err:.1e} of the aot engine")


def cli_tier_phase(tmp: str, device, smi_line: str) -> None:
    """22c: the operator's artifact commands, each `python -m
    shifu_tpu_torch.launcher.cli` in a child process, on phase 8a's job:
    `export --checkpoint-dir` against its final_model (weights bitwise,
    the scoring.pt2 programs' scores equal); `score --engine torch`,
    `--engine export` and `--native` on a data part (within SERVE_ATOL;
    torch and export equal); `eval --engine torch` against `evaluate` on
    the same rows (AUC within EVAL_AUC_ATOL); `serve --port 0` under
    `loadtest --connect` (0 errors).  Meanwhile `default_score`: `score`
    with no `--engine` on the fused FT artifact, on the card through
    the aot tier."""
    import dataclasses as dc
    import signal

    import torch
    from shifu_tpu_torch.config import job_config_from_shifu
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.data import reader
    from shifu_tpu_torch.export.artifact import load_artifact, params_from_jax
    from shifu_tpu_torch.export.scorer import ExportScorer
    from shifu_tpu_torch.train.loop import evaluate, init_state
    from shifu_tpu_torch.train.step import make_eval_step
    final = f"{tmp}/cli_cold/final_model"
    mc, cc = f"{tmp}/cli_ModelConfig.json", f"{tmp}/cli_ColumnConfig.json"
    parts = sorted(reader.list_data_files(f"{tmp}/cli_data"))
    # five commands together: export, three scores and eval
    t0 = time.perf_counter()
    export = cli_cmd(
        ["export", "--modelconfig", mc, "--columnconfig", cc,
         "--checkpoint-dir", f"{tmp}/cli_cold/tmp_model",
         "--output", f"{tmp}/cli_reexport",
         "--globalconfig", f"{tmp}/cli_cache.xml"], device)
    procs = {}
    for name, flags in (("torch", ["--engine", "torch"]),
                        ("export", ["--engine", "export"]),
                        ("native", ["--native"])):
        procs[name] = cli_cmd(
            ["score", "--model", final, "--input", parts[0], "--output",
             f"{tmp}/cli_scores_{name}.txt", *flags], device)
    ev = cli_cmd(["eval", "--model", final, "--columnconfig", cc,
                  "--modelconfig", mc, "--engine", "torch",
                  "--data", *parts[:CLI_EVAL_PARTS]], device)
    default = default_score(tmp, device)
    cli_wait("22c export", export)
    export_s = time.perf_counter() - t0
    for name, proc in procs.items():
        cli_wait(f"22c score {name}", proc)
    summary = json.loads(cli_wait("22c eval", ev).strip().splitlines()[-1])
    cmds_s = time.perf_counter() - t0
    with np.load(f"{final}/weights.npz") as a, \
            np.load(f"{tmp}/cli_reexport/weights.npz") as b:
        same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)
    probe = reader.read_file(parts[0])[:PROBE_ROWS, 1:]
    got = ExportScorer(f"{tmp}/cli_reexport", device).compute_batch(probe)
    want = ExportScorer(final, device).compute_batch(probe)
    if not same or not np.array_equal(got, want):
        fail(f"22c export: weights bitwise equal {same}; scoring.pt2 "
             f"scores max |diff| {np.abs(got - want).max():.3e}")
    scores = {n: read_scores(f"{tmp}/cli_scores_{n}.txt") for n in procs}
    n_rows = reader.read_file(parts[0]).shape[0]
    worst = max(float(np.abs(scores[a] - scores[b]).max())
                for a in scores for b in scores)
    if any(v.shape != (n_rows, 1) for v in scores.values()) \
            or worst > SERVE_ATOL \
            or not np.array_equal(scores["torch"], scores["export"]):
        fail(f"22c score: shapes {[v.shape for v in scores.values()]} "
             f"(want ({n_rows}, 1)), max pairwise {worst:.3e}; torch and "
             "export must write the same scores")
    job = job_config_from_shifu(mc, cc)
    job = job.replace(data=dc.replace(job.data, wire_dtype="float32"))
    cols = reader.project_columns(np.concatenate(
        [reader.read_file(p) for p in parts[:CLI_EVAL_PARTS]]), job.schema)
    held = pipe.TabularDataset(cols["features"], cols["target"],
                               cols["weight"])
    state = init_state(job, job.schema.feature_count, device)
    state.model.load_state_dict(params_from_jax(
        load_artifact(final).weights, state.model))
    _, auc = evaluate(state, held, job, make_eval_step(job),
                      torch.device(device))
    if summary["rows"] != held.num_rows \
            or abs(summary["auc"] - auc) > EVAL_AUC_ATOL:
        fail(f"22c eval: {summary}, evaluate's AUC {auc:.6f} on "
             f"{held.num_rows} rows (tol {EVAL_AUC_ATOL:g})")
    server = cli_cmd(["serve", final, "--port", "0"], device)
    try:
        port = serve_port("22c serve", server)
        out = cli_wait("22c loadtest", cli_cmd(
            ["loadtest", "--connect", f"127.0.0.1:{port}", "--rate",
             str(CLI_LOAD_RATE), "--duration", str(CLI_LOAD_SECONDS),
             "--senders", str(WIRE_SENDERS), "--json"], device))
        rep = json.loads(out.strip().splitlines()[-1])
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            server.kill()
            server.communicate()
    if server.returncode != 0:
        fail(f"22c serve: exit {server.returncode} after SIGTERM")
    report_load("22c loadtest --connect", rep, smi_line)
    say(f"22c: export --checkpoint-dir reproduced final_model (weights "
        f"bitwise, scoring.pt2 scores equal on {PROBE_ROWS} rows); score "
        f"--engine torch / --engine export / --native on {n_rows} rows and "
        f"eval --engine torch on {held.num_rows} rows; the five processes "
        f"together in {cmds_s:.2f} s (export's {export_s:.2f} s): "
        f"max pairwise {worst:.3e} (tol {SERVE_ATOL:g}), torch and export "
        f"equal; eval AUC {summary['auc']} against evaluate's {auc:.6f} "
        f"(tol {EVAL_AUC_ATOL:g}); {default}; {smi_line}")


def artifact_tier_phases(device, tmp: str, smi_line: str) -> None:
    tier_phase(tmp, device, smi_line)
    lap("22a engines (and 22b's pack)")
    cold_start_phase(tmp, device, smi_line)
    lap("22b cold start")
    cli_tier_phase(tmp, device, smi_line)
    lap("22c commands")


# -- phases 22d to 22f: the operator's views, detached jobs, tiering ----------

VIEW_TIMEOUT_S = 60
DETACH_EPOCHS = 2
KILL_EPOCHS = 2   # cut from 3 for phase 25: the resume trains epoch 1
KILL_SAVE_DELAY_S = 3
KILL_GRACE_S = 10.0     # launcher/detach.kill's default grace
# bench.py's 10M-vocab rung (bench.py:428-475)
TIER_VOCAB, TIER_DIM, TIER_HOT, TIER_BATCH, TIER_STEPS = (
    10_000_000, 16, 1 << 18, 4096, 24)


def cli_child(label: str, args: list, expect_rc: int = 0) -> tuple:
    """`python -m shifu_tpu_torch.launcher.cli <args>` run to its end:
    (stdout, seconds); fails on another exit code."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *args],
            cwd=root, capture_output=True, text=True,
            timeout=COLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"{label}: no exit within {COLD_TIMEOUT_S} s")
    took = time.perf_counter() - t0
    if proc.returncode != expect_rc:
        fail(f"{label}: exit {proc.returncode} (expected {expect_rc}): "
             f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return proc.stdout, took


def traced_dir(tmp: str, name: str) -> str:
    """The last attempt's dir of a traced_run (`name-<attempt>`)."""
    import glob
    dirs = glob.glob(os.path.join(tmp, f"{name}-*"))
    if not dirs:
        fail(f"no {name} journal under {tmp}")
    return max(dirs, key=lambda d: int(d.rsplit("-", 1)[1]))


def int8_rows(profile: dict) -> list:
    return [k for k in profile.get("kernels") or []
            if any(s in k["name"] for s in KERNEL_SYMBOLS["int8_matmul"])]


def views_phase(tmp: str, smi_line: str) -> None:
    """22d: every view of the port on this run's own journals."""
    fr = traced_dir(tmp, "fr_mlp")
    slo, drift = f"{tmp}/slo_obs", f"{tmp}/drift_obs"
    times = {}

    def view(label: str, args: list) -> dict:
        out, took = cli_child(f"22d {label}", args + ["--json"])
        times[label] = took
        return json.loads(out)

    m = view("metrics", ["metrics", fr])
    if [e["epoch"] for e in m["epochs"]] != [0, 1]:
        fail(f"22d metrics: epochs {m['epochs']} of 20a's journal")
    p = view("profile", ["profile", fr])
    if p["compiled_functions"] or not (p["device"] or {}).get("profiles"):
        fail(f"22d profile: compiled_functions {p['compiled_functions']}, "
             f"device {p['device']}: expected none and 20a's profile")
    t = view("trace", ["trace", fr])
    rows = int8_rows(t["profiles"][0]) if t["profiles"] else []
    if not rows:
        fail(f"22d trace: no #4 kernel in 20a's device profile "
             f"{t['profiles'][:1]}")
    top = view("top", ["top", slo, "--once"])
    if top["mode"] != "serving" or top["slo"]["alerts_total"] != 1:
        fail(f"22d top: mode {top['mode']}, slo {top['slo']}: expected "
             "21d's one p99 alert")
    fleet = view("top fleet", ["top", drift, slo, "--once"])["fleet"]
    if fleet["daemons"] != 2 or fleet["down"] != 0:
        fail(f"22d top over 21d's dirs: {fleet}")
    dr = view("drift", ["drift", drift])
    alerts = [md["alerts_total"] for md in dr["models"].values()]
    if alerts != [1]:
        fail(f"22d drift: alerts {alerts}, expected 21d's one")
    tl = view("timeline", ["timeline", slo, "--incident"])
    if [i["kind"] for i in tl["incidents"]] != ["slo_alert"]:
        fail(f"22d timeline: incidents {tl['incidents']}")
    cv = view("chaos-verify", ["chaos-verify", f"{tmp}/cli_sup_killed"])
    if cv["verdict"] != "PASS":
        fail(f"22d chaos-verify: {cv}")
    k = rows[0]
    say(f"22d views: trace lists #4 ({k['name'][:40]}) {k['calls']} calls, "
        f"{k['device_us']} us on the card in 20a's window; top: "
        f"{top['serving']['requests']} requests, p99 "
        f"{top['serving']['p99_ms']} ms, one p99 alert; drift: one "
        f"feature_psi alert; timeline: one slo_alert incident, recovery "
        f"{tl['incidents'][0]['recovery_s']} s; chaos-verify: PASS "
        f"({cv['injected_total']} injection(s)); seconds "
        + ", ".join(f"{n} {s:.3f}" for n, s in times.items())
        + f" [{smi_line}]")


def detach_argv(tmp: str, out: str, epochs: int, device) -> list:
    """8a's train command (its data, the hot cache) into `out`, epochs 0
    and 1 traced (a window whose device events the profiler lost leaves
    the other)."""
    from shifu_tpu_torch.utils import xmlconfig
    xml = f"{tmp}/cli_detach.xml"
    xmlconfig.write_configuration_xml({
        "shifu.application.batch-size": str(TRAIN_BATCH),
        "shifu.data.wire-dtype": "int8",
        "shifu.data.device-resident-bytes": "0",
        "shifu.data.cache-dir": f"{tmp}/cli_cache",
        "shifu.obs.trace-epochs": "0,1",
        "shifu.obs.trace-top-k": "64"}, xml)
    return cli_argv(tmp, f"{tmp}/cli_data", xml, out, device) + [
        "--epochs", str(epochs)]


def process_tree(pid: int) -> list:
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        try:
            with open(f"/proc/{p}/task/{p}/children") as f:
                todo += [int(k) for k in f.read().split()]
        except OSError:
            pass
    return out


def job_status(label: str, out: str) -> dict:
    return json.loads(cli_child(f"{label} status", ["status", out])[0])


def detach_phase(tmp: str, device, smi_line: str) -> None:
    """22e: `train --detach`, `status`, `attach`, `kill` on 8a's job."""
    from shifu_tpu_torch.launcher import detach
    from shifu_tpu_torch.obs import render

    out = f"{tmp}/cli_detach"
    t0 = time.perf_counter()
    sub, submit_s = cli_child("22e submit",
                              detach_argv(tmp, out, DETACH_EPOCHS, device)
                              + ["--detach"])
    st = job_status("22e", out)
    if st["state"] != "RUNNING":
        fail(f"22e: status after submit {st}")
    _, attach_s = cli_child("22e attach", ["attach", out])
    to_exit = time.perf_counter() - t0
    st = job_status("22e", out)
    if (st["state"], st.get("exit")) != ("FINISHED", 0):
        fail(f"22e: status after attach {st}")
    tr = render.trace_summary(out)
    rows = [k for p in (tr or {}).get("profiles") or [] for k in int8_rows(p)]
    if not rows or not sum(k["calls"] for k in rows):
        fail(f"22e: no #4 launch in the detached job's device profile "
             f"{(tr or {}).get('profiles', [])[:1]}")
    with open(f"{out}/{detach.LOG_FILE}") as f:
        log = f.read()
    say(f"22e detach: submit returned in {submit_s:.3f} s "
        f"({sub.splitlines()[0]}); status RUNNING; attach followed the "
        f"board for {attach_s:.3f} s to exit 0; status FINISHED; "
        f"{to_exit:.3f} s from submit to exit ({DETACH_EPOCHS} epochs of "
        f"8a's job on the card, the supervised daemon's and its attempt's "
        f"start-up included); #4 {sum(k['calls'] for k in rows)} calls, "
        f"{sum(k['device_us'] for k in rows):.3f} us in the traced windows; "
        f"supervisor.log {len(log)} bytes [{smi_line}]")

    kout = f"{tmp}/cli_detach_kill"
    plan = {"faults": [{"site": "checkpoint.save", "at_call": 1,
                        "action": "delay", "delay_s": KILL_SAVE_DELAY_S,
                        "scope": "job"}]}
    argv = detach_argv(tmp, kout, KILL_EPOCHS, device)
    cli_child("22e submit (kill)",
              argv + ["--detach", "--chaos-plan", json.dumps(plan)])
    with open(f"{kout}/{detach.JOB_FILE}") as f:
        pid = json.load(f)["pid"]
    board = f"{kout}/console.board"
    deadline = time.monotonic() + COLD_TIMEOUT_S
    while not (os.path.exists(board) and "Epoch 0:" in open(board).read()):
        if time.monotonic() > deadline or not detach._alive(pid):
            fail(f"22e kill: epoch 0 did not end within {COLD_TIMEOUT_S} "
                 f"s: {job_status('22e kill', kout)}")
        time.sleep(0.05)
    tree = process_tree(pid)
    t0 = time.perf_counter()
    kill_out, kill_s = cli_child("22e kill", ["kill", kout])
    while any(detach._alive(p) for p in tree):
        if time.perf_counter() - t0 > KILL_GRACE_S + 5:
            fail(f"22e kill: processes {[p for p in tree if detach._alive(p)]}"
                 f" of the tree alive {KILL_GRACE_S + 5} s after kill")
        time.sleep(0.02)
    gone_s = time.perf_counter() - t0
    st = job_status("22e kill", kout)
    if gone_s > KILL_GRACE_S or (st["state"], st.get("exit")) != (
            "FAILED", 143) or "terminated" not in kill_out:
        fail(f"22e kill: the tree gone after {gone_s:.3f} s (grace "
             f"{KILL_GRACE_S} s), status {st}, kill said {kill_out!r}")
    _, resume_s = cli_child("22e resume", argv)
    recs = journal(f"{kout}/telemetry")
    resumes = [r["epoch"] for r in recs if r["kind"] == "train_resume"]
    graces = [r for r in recs if r["kind"] == "preemption_grace"]
    if not resumes or not graces:
        fail(f"22e resume: train_resume {resumes}, preemption_grace "
             f"{graces}")
    say(f"22e kill: the {len(tree)} processes of its tree (the daemon, its "
        f"attempt and the attempt's children) gone "
        f"{gone_s:.3f} s after kill started (`kill` returned in "
        f"{kill_s:.3f} s; SIGTERM, the drain's save, exit 143; grace "
        f"{KILL_GRACE_S} s); the plain train on the same --output resumed "
        f"at epoch {resumes[-1]} and ran to exit 0 in {resume_s:.3f} s "
        f"[{smi_line}]")


def tiering_phase(tmp: str, smi_line: str) -> None:
    """22f: bench.py's 10M-vocab tiered rung on this machine's host."""
    from shifu_tpu_torch.embed.tiering import TieredTable
    from shifu_tpu_torch.obs import render
    tele = f"{tmp}/tier_obs"
    configure_obs(tele)
    # zeros page lazily; the cold store's I/O is content-blind
    table = np.zeros((1, TIER_VOCAB, TIER_DIM), np.float32)
    t0 = time.perf_counter()
    tiered = TieredTable.build(table, f"{tmp}/tier", hot_rows=TIER_HOT,
                               tier_dtype="int8")
    build_s = time.perf_counter() - t0
    del table
    rng = np.random.default_rng(11)
    ids = ((rng.zipf(1.1, size=(TIER_STEPS, TIER_BATCH, 1)) - 1)
           % TIER_VOCAB).astype(np.int32)
    tiered.lookup(ids[0])  # warm: the page cache and the prefetch dict
    t0 = time.perf_counter()
    for s in range(1, TIER_STEPS):
        got = tiered.lookup(ids[s])
    dt = time.perf_counter() - t0
    if got.shape != (TIER_BATCH, 1, TIER_DIM) or np.any(got != 0.0):
        fail(f"22f tiering: lookup gave {got.shape}, nonzero "
             f"{int(np.count_nonzero(got))} on an all-zero table")
    rep = tiered.tier_report()
    payload = os.path.getsize(f"{tiered.cold_dir}/table.bin")
    if payload != TIER_VOCAB * TIER_DIM or not 0 < rep["hit_rate"] < 1:
        fail(f"22f tiering: payload {payload} bytes, hit rate "
             f"{rep['hit_rate']}")
    from shifu_tpu_torch import obs
    obs.flush()
    prof = render.profile_summary(tele)
    if (prof["embed"] or {}).get("tier", {}).get("hit_rate") != \
            rep["hit_rate"]:
        fail(f"22f tiering: profile's embed rollup {prof['embed']}")
    say(f"22f tiering: {TIER_VOCAB} x {TIER_DIM} int8 cold store "
        f"({payload / 2 ** 20:.1f} MiB) and {TIER_HOT} hot rows built in "
        f"{build_s:.3f} s; {(TIER_STEPS - 1) * TIER_BATCH / dt:.1f} rows/s "
        f"over {TIER_STEPS - 1} zipf(1.1) batches of {TIER_BATCH}; hit rate "
        f"{rep['hit_rate']}; cold {rep['cold_bytes'] / 2 ** 20:.2f} MiB in "
        f"{rep['cold_seconds']:.3f} s of host reads (this machine's host, "
        f"{len(os.sched_getaffinity(0))} CPUs) [{smi_line}]")


def operator_phases(device, tmp: str, smi_line: str) -> None:
    views_phase(tmp, smi_line)
    lap("22d views")
    detach_phase(tmp, device, smi_line)
    lap("22e detach")
    tiering_phase(tmp, smi_line)
    lap("22f tiering")


# -- phases 22g and 22h: the serving fleet ------------------------------------

# 22g: 3 members and 1 standby on local:2 behind the router, heartbeat
# 0.5 s x 3 (a 1.5 s TTL); the socket loadtest at a fixed offered rate, the
# member key k0 routes to killed FLEET_KILL_AT_S after the router's first
# routed score, then the member the traffic routes to (RouterServer routes
# every wire request under the key "default") FLEET_KILL2_AT_S after it or
# once the standby pool is refilled
FLEET_DAEMONS, FLEET_STANDBYS, FLEET_HOSTS = 3, 1, "local:2"
FLEET_HEARTBEAT_S, FLEET_MISSES = 0.5, 3
FLEET_RATE, FLEET_SENDERS, FLEET_SECONDS = 400.0, 16, 8.0
FLEET_KILL_AT_S, FLEET_KILL2_AT_S = 3.0, 5.0
FLEET_KILL_KEY, FLEET_TRAFFIC_KEY = "k0", "default"
# 22h: the `fleet` command with 2 `serve` children and 1 standby child
FLEET_CMD_DAEMONS, FLEET_CMD_STANDBYS = 2, 1
FLEET_CMD_LOAD_RATE, FLEET_CMD_LOAD_SECONDS = 200.0, 3.0
FLEET_CMD_TIMEOUT_S = 300
FLEET_STOP_GRACE_S = 10.0


def journal_since(path: str, kind: str, t0: float) -> list:
    return [r for r in journal(path) if r["kind"] == kind
            and r.get("ts", 0.0) >= t0]


def fleet_launch_check(label: str, launches: dict, want5: int,
                       block: str) -> None:
    """#5 once a batch, `block` (#1 fused, #2 unfused) 3 x, no other."""
    layers = ft_serving_spec().num_layers
    want = {block: layers * want5, "embedding_lookup": want5}
    if want5 <= 0 or launches != {k: want.get(k, 0) for k in launches}:
        fail(f"{label}: launches {launches}, expected {want} and no other "
             "kernel")


def free_port_base(n: int) -> int:
    """A port whose next `n` ports are free (the process-mode members')."""
    import socket
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65536:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                k = socket.socket()
                socks.append(k)
                k.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for k in socks:
                k.close()
    fail("22h: no free range of member ports")


def warm_loadtest_child() -> None:
    """The loadtest's imports (torch among them) in the spawned child, so
    that its traffic starts at once when the drill asks for it."""
    from shifu_tpu_torch.runtime import loadtest  # noqa: F401


def fleet_phase(tmp: str, device, smi_line: str) -> None:
    """22g: FleetManager on the card (3 members, 1 standby, local:2) behind
    RouterServer; a socket loadtest from a spawned process while the member
    key k0 routes to and then the member the traffic routes to are killed;
    then swap_fleet to the unfused artifact; the views as CLI children."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.config.schema import FleetConfig, ServingConfig
    from shifu_tpu_torch.export.scorer import TorchScorer
    from shifu_tpu_torch.runtime import fleet as fleet_mod
    from shifu_tpu_torch.runtime import serve_wire
    from shifu_tpu_torch.runtime.router import RouterServer

    fused, unfused = f"{tmp}/fused", f"{tmp}/unfused"
    tele, root = f"{tmp}/fleet_obs", f"{tmp}/fleet"
    configure_obs(tele)
    cfg = FleetConfig(n_daemons=FLEET_DAEMONS, standbys=FLEET_STANDBYS,
                      hosts=FLEET_HOSTS, heartbeat_every_s=FLEET_HEARTBEAT_S,
                      heartbeat_misses=FLEET_MISSES)
    t0 = time.perf_counter()
    mgr = fleet_mod.FleetManager(
        fused, fleet=cfg, serving=ServingConfig(report_every_s=0.0),
        root_dir=root, device=device).start()
    start_s = time.perf_counter() - t0
    front = RouterServer(mgr.router, manager=mgr).start()
    pool = multiprocessing.get_context("spawn").Pool(1)
    probe_row = make_rows(1, serving_schema(), np.random.default_rng(SEED + 8))

    def primary(key: str):
        return mgr.members[mgr.router.candidates(key)[0].member_id]

    def standby_off(host_id: str, deadline: float):
        """A standby on another host than `host_id` (any, for ""), waited
        for while the pool refills: the one failover promotes first."""
        while True:
            with mgr._lock:
                other = [s for s in mgr.standbys if s.host_id != host_id]
            if other:
                return other[0]
            if time.monotonic() > deadline:
                fail(f"22g: no standby off {host_id!r}: "
                     f"{[(s.member_id, s.host_id) for s in mgr.standbys]}")
            time.sleep(0.005)

    def kill_and_fail_over(victim, t_kill: float) -> float:
        """Kill `victim`, wait for the manager's failover, then time the
        promoted standby's first answer: seconds from the kill.  The wait
        reads the manager's books, not the journal: parsing the journal
        in a loop would hold the GIL the members and the router share."""
        with mgr._lock:
            before, n = set(mgr.members), mgr._failovers
        victim.kill()
        deadline = time.monotonic() + 10 * cfg.heartbeat_ttl_s
        while mgr.summary()["failovers"] <= n:
            if time.monotonic() > deadline:
                fail(f"22g: no failover {10 * cfg.heartbeat_ttl_s} s after "
                     f"the kill of {victim.member_id}")
            time.sleep(0.005)
        with mgr._lock:
            promoted = [mgr.members[i] for i in set(mgr.members) - before]
        if len(promoted) != 1:
            fail(f"22g: the failover of {victim.member_id} promoted "
                 f"{[m.member_id for m in promoted]}")
        with serve_wire.ServeClient(promoted[0].host, promoted[0].port,
                                    timeout=30) as c:
            c.score_rows(probe_row, dtype=serve_wire.DTYPE_F32)
        return time.time() - t_kill

    try:
        victim = primary(FLEET_KILL_KEY)
        victim2 = primary(FLEET_TRAFFIC_KEY)
        standby = mgr.standbys[0]
        if victim2 is victim or standby.host_id == victim.host_id:
            fail(f"22g: {FLEET_KILL_KEY} routes to {victim.member_id}@"
                 f"{victim.host_id}, {FLEET_TRAFFIC_KEY!r} to "
                 f"{victim2.member_id}@{victim2.host_id}, the standby is "
                 f"{standby.member_id}@{standby.host_id}: expected two "
                 "members and a standby off the first one's host")
        # the child's start-up, then its imports, off the clock
        pool.apply(time.sleep, (0,))
        t0 = time.perf_counter()
        pool.apply(warm_loadtest_child)
        import_s = time.perf_counter() - t0
        reset_launches()
        t_reset = time.time()
        routed0 = mgr.router.router_stats()["routed"]
        load = pool.apply_async(socket_loadtest, (front.port,), dict(
            rate=FLEET_RATE, duration=FLEET_SECONDS, senders=FLEET_SENDERS,
            seed=SEED + 7))
        # the kills are timed from the traffic's first routed score (the
        # loadtest's STATS probe is routed first), not from the request to
        # the child: a kill before the traffic starts exercises nothing
        deadline = time.monotonic() + 120
        while mgr.router.router_stats()["routed"] < routed0 + 2:
            if load.ready() or time.monotonic() > deadline:
                fail(f"22g: the loadtest routed no score "
                     f"{time.time() - t_reset:.3f} s after it was started: "
                     f"{mgr.router.router_stats()}")
            time.sleep(0.005)
        t_load = time.time()
        time.sleep(FLEET_KILL_AT_S)
        t_kill = time.time()
        answer_s = kill_and_fail_over(victim, t_kill)
        # the second kill cuts the traffic's own connections: the router
        # must hedge them to the next member with no error to a sender
        standby2 = standby_off(victim2.host_id, time.monotonic() + 30)
        time.sleep(max(0.0, t_load + FLEET_KILL2_AT_S - time.time()))
        t_kill2 = time.time()
        if t_kill2 - t_load > FLEET_SECONDS - 1.0 or load.ready():
            fail(f"22g: the second kill came {t_kill2 - t_load:.3f} s into "
                 f"the {FLEET_SECONDS:g} s loadtest (ended: {load.ready()})")
        routed_kill2 = mgr.router.router_stats()["routed"]
        answer2_s = kill_and_fail_over(victim2, t_kill2)
        routed_fo2 = mgr.router.router_stats()["routed"]
        rep = load.get(timeout=FLEET_SECONDS + 300)
        pool.close()
        pool.join()
        # the pool's refill after the second failover warms its rungs on
        # the card: wait for it, so that its warm-up calls are journaled
        standby_off("", time.monotonic() + 30)
        obs.flush()
        launches = read_launches()
        routed = mgr.router.router_stats()
        dirs = mgr.member_dirs()
        members = ([m for m in mgr.members.values()] + mgr.standbys
                   + [victim, victim2])
        dispatched = sum(m.daemon.stats()["batches"]
                         + m.daemon.stats()["direct_batches"]
                         for m in members)
        warm = sum(len(r["buckets"]) for r in
                   journal_since(tele, "model_prewarm", t_reset))
        fo = journal_since(tele, "fleet_failover", t_reset)
        want_fo = [(victim.member_id, standby.member_id),
                   (victim2.member_id, standby2.member_id)]
        if [(r["member"], r["standby"]) for r in fo] != want_fo or any(
                r["standby_host"] == r["host"] for r in fo):
            fail(f"22g: fleet_failover events {fo}, expected one a kill: "
                 f"{want_fo}, each standby off its victim's host")
        if routed["hedges"] < 1 or routed["errors"] != 0:
            fail(f"22g: the router after killing the traffic's member "
                 f"{victim2.member_id}: {routed} (expected a hedge and no "
                 f"error); the traffic started {t_load - t_reset:.3f} s "
                 f"after the loadtest was, the kill came "
                 f"{t_kill2 - t_load:.3f} s into it, {routed_fo2 - routed_kill2}"
                 f" requests routed from the kill to its failover, the "
                 f"loadtest's reconnects {rep.get('reconnects')}, errors "
                 f"{rep.get('errors')}")
        report_load("22g fleet", rep, smi_line)
        fleet_launch_check("22g fleet", launches, dispatched + warm,
                           "ft_block")
        failover_s = fo[0]["ts"] - t_kill
        failover2_s = fo[1]["ts"] - t_kill2

        # the swap to the unfused artifact; past the barrier, #2 and not #1
        t0 = time.perf_counter()
        swap = mgr.swap_fleet(unfused)
        swap_s = time.perf_counter() - t0
        if not swap["ok"] or mgr.summary()["generation"] != 1:
            fail(f"22g swap: {swap}")
        reset_launches()
        probe = make_rows(PROBE_ROWS, serving_schema(),
                          np.random.default_rng(SEED + 42))
        with serve_wire.ServeClient(front.host, front.port,
                                    timeout=120) as c:
            got = c.score_rows(probe, dtype=serve_wire.DTYPE_F32)
        launches_swap = read_launches()
        fleet_launch_check("22g after the swap", launches_swap, 1,
                           "small_attention")
        want = TorchScorer(unfused, device="cpu").compute_batch(probe)
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        if err > SERVE_ATOL:
            fail(f"22g swap: {PROBE_ROWS} probe rows through the router vs "
                 f"the unfused CPU scorer: shape {got.shape}, max |diff| "
                 f"{err:.3e} > {SERVE_ATOL}")

        # the views, as CLI children, while the fleet still runs
        obs.flush()
        views = {}
        out, views["fleet-verify"] = cli_child(
            "22g fleet-verify", ["fleet-verify", tele, "--json"])
        if json.loads(out)["verdict"] != "PASS":
            fail(f"22g fleet-verify: {out}")
        out, views["timeline"] = cli_child(
            "22g timeline", ["timeline", tele, "--incident", "--json"])
        inc = [i for i in json.loads(out)["incidents"]
               if i["kind"] == "fleet_failover"]
        if sorted(i["root"].get("member") for i in inc) != sorted(
                [victim.member_id, victim2.member_id]):
            fail(f"22g timeline: failover incidents {inc}")
        out, views["top"] = cli_child(
            "22g top", ["top", *dirs, "--once", "--json"])
        roll = json.loads(out)["fleet"]
        if roll["down"] != 2 or roll["daemons"] != len(dirs):
            fail(f"22g top over {len(dirs)} member dirs: {roll}")
    finally:
        pool.terminate()
        front.close()
        mgr.stop()
    say(f"22g fleet: {FLEET_DAEMONS} members + {FLEET_STANDBYS} standby on "
        f"{FLEET_HOSTS} ({device}) up in {start_s:.3f} s; the loadtest "
        f"through the router: {rep['achieved_scores_per_sec']} rows/s "
        f"achieved of {FLEET_RATE:g} offered, exact p50 {rep['p50_ms']} ms "
        f"p99 {rep['p99_ms']} ms, 0 errors, its child's imports "
        f"{import_s:.3f} s before the clock and its first score routed "
        f"{t_load - t_reset:.3f} s after it was started; {victim.member_id}@"
        f"{victim.host_id} ({FLEET_KILL_KEY}'s) killed "
        f"{t_kill - t_load:.3f} s into the traffic: fleet_failover "
        f"{failover_s:.3f} s after "
        f"the kill (TTL {cfg.heartbeat_ttl_s:g} s), {standby.member_id}@"
        f"{standby.host_id} promoted and answering {answer_s:.3f} s after "
        f"the kill; {victim2.member_id}@{victim2.host_id} (the traffic's) "
        f"killed {t_kill2 - t_load:.3f} s into it: fleet_failover "
        f"{failover2_s:.3f} s after ({routed_fo2 - routed_kill2} routed "
        f"between), {standby2.member_id}@"
        f"{standby2.host_id} answering {answer2_s:.3f} s after the kill, "
        f"the router {routed['routed']} routed, {routed['hedges']} hedged, "
        f"{routed['errors']} errors; launches {launches} ({dispatched} "
        f"batches dispatched + {warm} warm-up calls); swap_fleet to the "
        f"unfused artifact {swap_s:.3f} s to the barrier, then {PROBE_ROWS} "
        f"probe rows through the router: launches {launches_swap}, max "
        f"|diff| {err:.3e} vs the CPU scorer (tol {SERVE_ATOL:g}); "
        f"fleet-verify PASS, timeline two failover incidents, top "
        f"{roll['down']} of {roll['daemons']} DOWN; seconds "
        + ", ".join(f"{n} {t:.3f}" for n, t in views.items())
        + f" [{smi_line}]")


def children_on_card(root: str, members: list, device) -> str:
    """Each `serve` child's own account over the wire (STATS): the device
    its engine scores on and its process's kernel launches, #1 = 3 x #5
    from its warm-up and no other kernel (none on the CPU).  Returns what
    was seen; fails otherwise."""
    from shifu_tpu_torch.runtime import serve_wire
    layers = ft_serving_spec().num_layers
    seen = {}
    for m in members:
        start = [r for r in journal(f"{root}/{m}")
                 if r["kind"] == "serve_start"]
        with serve_wire.ServeClient("127.0.0.1", start[-1]["port"],
                                    timeout=60) as c:
            st = c.stats()
        got, n5 = st.get("launches"), st.get("launches", {}).get(
            "embedding_lookup", 0)
        want = ({"ft_block": layers * n5, "embedding_lookup": n5}
                if device.type == "cuda" else {})
        if str(st.get("device")).split(":")[0] != device.type \
                or got != want or (device.type == "cuda" and n5 <= 0):
            fail(f"22h: {m} (port {start[-1]['port']}) says device "
                 f"{st.get('device')}, launches {got}; expected "
                 f"{device.type} and #1 = {layers} x #5 > 0, no other "
                 "kernel")
        seen[m] = f"{st['device']} {got}"
    return "; ".join(f"{m} on {v}" for m, v in seen.items())


def fleet_command_phase(tmp: str, device, smi_line: str) -> None:
    """22h: the `fleet` command with `serve` children on the card."""
    import signal

    from shifu_tpu_torch.launcher import detach
    from shifu_tpu_torch.runtime import fleet as fleet_mod
    from shifu_tpu_torch.runtime import serve_wire
    from shifu_tpu_torch.utils import xmlconfig

    root = f"{tmp}/fleet_cmd"
    xml = f"{tmp}/fleet_cmd.xml"
    n_children = FLEET_CMD_DAEMONS + FLEET_CMD_STANDBYS
    xmlconfig.write_configuration_xml({
        "shifu.fleet.member-port-base": str(free_port_base(n_children + 2)),
        "shifu.fleet.heartbeat-every-s": str(FLEET_HEARTBEAT_S),
        "shifu.fleet.heartbeat-misses": str(FLEET_MISSES)}, xml)
    env = dict(os.environ, SHIFU_TPU_METRICS_DIR=root)
    argv = [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", "fleet",
            f"{tmp}/fused", "--member-mode", "process", "--hosts",
            FLEET_HOSTS, "--n-daemons", str(FLEET_CMD_DAEMONS),
            "--standbys", str(FLEET_CMD_STANDBYS), "--port", "0",
            "--root-dir", root, "--globalconfig", xml]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(
        __file__)), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: list = []
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    try:
        deadline = time.monotonic() + FLEET_CMD_TIMEOUT_S
        while not any(ln.startswith("fleet: ") for ln in lines):
            if proc.poll() is not None or time.monotonic() > deadline:
                fail(f"22h: the fleet did not start: {''.join(lines)[-3000:]}")
            time.sleep(0.05)
        line = [ln for ln in lines if ln.startswith("fleet: ")][0]
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        probe = make_rows(4, serving_schema(), np.random.default_rng(SEED))
        with serve_wire.ServeClient("127.0.0.1", port, timeout=120) as c:
            c.score_rows(probe, dtype=serve_wire.DTYPE_F32)
        first_s = time.perf_counter() - t0
        members = [f"member-{i}" for i in range(n_children)]
        leases = {m: fleet_mod.read_lease(f"{root}/{m}") for m in members}
        if any(v is None for v in leases.values()):
            fail(f"22h: leases {leases}")
        on_card = children_on_card(root, members, device)
        out, load_s = cli_child("22h loadtest", [
            "loadtest", "--connect", f"127.0.0.1:{port}", "--rate",
            str(FLEET_CMD_LOAD_RATE), "--duration",
            str(FLEET_CMD_LOAD_SECONDS), "--senders", "8", "--json"])
        rep = json.loads(out)
        report_load("22h fleet command", rep, smi_line)
        victim = leases["member-0"]["pid"]
        t_kill = time.time()
        os.killpg(victim, signal.SIGKILL)
        deadline = time.monotonic() + 20 * FLEET_HEARTBEAT_S * FLEET_MISSES
        fo = []
        while not fo:
            if time.monotonic() > deadline:
                fail("22h: no fleet_failover after the kill")
            time.sleep(0.02)
            fo = journal_since(root, "fleet_failover", t_kill)
        failover_s = fo[0]["ts"] - t_kill
        tree = process_tree(proc.pid)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail("22h: the fleet did not exit within 60 s of SIGTERM")
        while any(detach._alive(p) for p in tree):
            if time.perf_counter() - t_term > FLEET_STOP_GRACE_S:
                fail(f"22h: {[p for p in tree if detach._alive(p)]} alive "
                     f"{FLEET_STOP_GRACE_S} s after SIGTERM")
            time.sleep(0.02)
        gone_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
    if rc != 0:
        fail(f"22h: the fleet exited {rc}: {''.join(lines)[-3000:]}")
    out, verify_s = cli_child("22h fleet-verify",
                              ["fleet-verify", root, "--json"])
    if json.loads(out)["verdict"] != "PASS":
        fail(f"22h fleet-verify: {out}")
    say(f"22h fleet command: {FLEET_CMD_DAEMONS} serve children + "
        f"{FLEET_CMD_STANDBYS} standby child on {FLEET_HOSTS} ({on_card}), "
        f"{first_s:.3f} s from spawn to the first routed answer; loadtest "
        f"--connect {rep['completed']} rows, "
        f"{rep['achieved_scores_per_sec']} rows/s, p50 {rep['p50_ms']} ms "
        f"p99 {rep['p99_ms']} ms, 0 errors ({load_s:.3f} s as a child); "
        f"member-0's tree SIGKILLed: fleet_failover {failover_s:.3f} s "
        f"after; SIGTERM: exit 0, its {len(tree)} processes gone in "
        f"{gone_s:.3f} s; fleet-verify PASS ({verify_s:.3f} s) "
        f"[{smi_line}]")


def fleet_phases(device, tmp: str, smi_line: str) -> None:
    fleet_phase(tmp, device, smi_line)
    lap("22g fleet")
    fleet_command_phase(tmp, device, smi_line)
    lap("22h fleet command")


# -- phase 23: data- and vocab-parallel training on torch.distributed --------

MESH_MLP_STEPS = 8           # the headline MLP at TRAIN_BATCH, one epoch
MESH_FT_STEPS = 4            # the fused FT at FT_BATCH, one epoch
MESH_DEEPFM_STEPS = 4        # DeepFM at 100k vocab, DEEPFM_BATCH, an epoch
MESH_DEEPFM_EPOCHS = 2       # epoch 0 pays each rank's first use
MESH_PROFILE_STEPS = 3       # mesh steps under 23a's profiler window
MESH_CHILD_TIMEOUT_S = 300
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6   # 23a: world 1 against no mesh (f32)
# phase 24: tensor-, pipeline- and sequence-parallel training
MESH_TP_STEPS = 4            # 24a's DeepFM, MoE and ruled MLP, one epoch
MESH_SEQ_STEPS = 2           # 24a's FT on seq=2 at FT_BATCH, one epoch
MESH_SEQ_FEATURES = 31       # S = 32 tokens, which seq=2 divides
MESH_PIPE_BATCH = 8190       # 24b/24c: 3 microbatches must divide it
MESH_PIPE_STEPS = 3          # 24b/24c, one epoch
MESH_PIPE_STAGES = 3         # one layer of the FT rung's three a stage
MESH_RULES = ((r".*hidden_layer.*kernel", (None, "model")),)


def mesh_paths() -> dict:
    """Phase 23's jobs, label -> (job, train, valid), from SEED alone (the
    children build the same): the headline MLP on the int8 wire (#4),
    the fused FT (#1), DeepFM at the 100k-vocab shape with the sparse
    Adadelta on the per-batch tier (#5, #6)."""
    from shifu_tpu_torch.data import synthetic
    mlp = headline_job(epochs=1)
    ft = ft_job(synthetic.make_schema(num_features=30), FT_BATCH, 1)
    dfm = dlrm_job("deepfm", deepfm_schema(DEEPFM_VOCAB), DEEPFM_BATCH,
                   epochs=MESH_DEEPFM_EPOCHS, staged=False, sparse="on")
    return {
        "MLP": (mlp, *synthetic_datasets(
            mlp.schema, MESH_MLP_STEPS * TRAIN_BATCH, TRAIN_BATCH, SEED)),
        "FT fused": (ft, *synthetic_datasets(
            ft.schema, MESH_FT_STEPS * FT_BATCH, FT_BATCH, SEED)),
        "DeepFM": (dfm, *synthetic_datasets(
            dfm.schema, MESH_DEEPFM_STEPS * DEEPFM_BATCH, DEEPFM_BATCH,
            SEED + 3)),
    }


def tp_paths() -> dict:
    """Phase 24a's jobs, label -> (job, mesh axes, train, valid, the
    launches a rank makes as a function of (steps, evals)), from SEED
    alone (23b's ranks build the same)."""
    from shifu_tpu_torch.config.schema import OptimizerConfig
    from shifu_tpu_torch.data import synthetic
    dfm = dlrm_job("deepfm", deepfm_schema(DEEPFM_VOCAB), DEEPFM_BATCH,
                   staged=False, sparse="off")
    dfm = dfm.replace(train=dataclasses.replace(
        dfm.train, optimizer=OptimizerConfig(name="adam",
                                             learning_rate=1e-3)))
    moe = ladder_job("moe_mlp")
    moe = moe.replace(
        model=dataclasses.replace(moe.model, num_experts=4),
        train=dataclasses.replace(moe.train, epochs=1))
    mlp = headline_job(epochs=1)
    mlp = mlp.replace(runtime=dataclasses.replace(
        mlp.runtime, param_sharding_rules=MESH_RULES))
    seq_schema = synthetic.make_schema(num_features=MESH_SEQ_FEATURES,
                                       num_categorical=6, vocab_size=1000)
    lookups = (lambda st, ev: {"embedding_lookup": st + ev})
    out = {
        "DeepFM field": (dfm, {"model": 2}, *synthetic_datasets(
            dfm.schema, MESH_TP_STEPS * DEEPFM_BATCH, DEEPFM_BATCH,
            SEED + 5), lookups),
        "MoE experts": (moe, {"model": 2}, *synthetic_datasets(
            moe.schema, MESH_TP_STEPS * LADDER_BATCH, LADDER_BATCH,
            SEED + 6), lambda st, ev: {}),
        "MLP rules": (mlp, {"model": 2}, *synthetic_datasets(
            mlp.schema, MESH_TP_STEPS * TRAIN_BATCH, TRAIN_BATCH, SEED + 7),
            lambda st, ev: {"int8_matmul": st + ev}),
    }
    for impl in ("ring", "ulysses"):
        job = ft_job(seq_schema, FT_BATCH, 1, attention_impl=impl)
        # f32, as the FT locksteps: ring attention streams its softmax in
        # f32 where world 1's local route takes #2 in bf16, and bf16's
        # rounding moves an Adadelta change by more than the 1e-2 it is
        # held to (tiny gradients flip sign)
        job = job.replace(model=dataclasses.replace(
            job.model, compute_dtype=LOCKSTEP_FT_DTYPE))
        out[f"FT {impl}"] = (job, {"seq": 2}, *synthetic_datasets(
            seq_schema, MESH_SEQ_STEPS * FT_BATCH, FT_BATCH, SEED + 8),
            lookups)
    return out


def pipe_path(stages: int = MESH_PIPE_STAGES,
              dtype: str = "bfloat16") -> tuple:
    """Phase 24b/24c's FT job (the rung with 6 categorical columns, its
    trunk stacked into `stages` stages; 1: per block) in `dtype` and its
    data."""
    from shifu_tpu_torch.data import synthetic
    schema = synthetic.make_schema(num_features=30, num_categorical=6,
                                   vocab_size=1000)
    job = ft_job(schema, MESH_PIPE_BATCH, 1, pipeline_stages=stages)
    job = job.replace(model=dataclasses.replace(job.model,
                                                compute_dtype=dtype))
    return (job, *synthetic_datasets(schema, MESH_PIPE_STEPS
                                     * MESH_PIPE_BATCH, MESH_PIPE_BATCH,
                                     SEED + 9))


def param_arrays(model) -> dict:
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def nccl_events(prof) -> tuple[dict, dict]:
    """({NCCL device kernel: calls}, {NCCL host op: calls}) of a profile:
    kernels from NCCL's library (ncclDevKernel_*, and oneRankReduce, the
    kernel of a one-rank reduction) and the `nccl:*` ranges that
    ProcessGroupNCCL records around each collective."""
    kernels, ops = {}, {}
    for e in prof.key_averages():
        low = e.key.lower()
        if low.startswith("nccl:"):
            ops[e.key] = ops.get(e.key, 0) + e.count
        elif ("nccl" in low or "onerank" in low) and (
                getattr(e, "device_time_total", 0) or 0) > 0:
            name = "oneRankReduce" if "onerank" in low else e.key[:80]
            kernels[name] = kernels.get(name, 0) + e.count
    return kernels, ops


def nccl_child(out_path: str, device: str, gate: str) -> None:
    """23a, a spawned process with the environment contract of one rank:
    NCCL at world 1 and an explicit data=1 mesh.  For the MLP (#4) and the
    fused FT (#1), `train` without a mesh and then through the mesh
    (launches counted), the final parameters compared; then, once the file
    `gate` exists (23b's ranks have ended: a profile taken beside another
    process on the card can lose device events), a profiler window over
    mesh steps of the MLP.  Writes its findings to `out_path` as JSON."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from shifu_tpu_torch.config.schema import MeshConfig
    from shifu_tpu_torch.parallel import distributed, make_mesh
    from shifu_tpu_torch.train import step as step_lib
    from shifu_tpu_torch.train.loop import init_state, to_device, train

    dev = torch.device(device)
    distributed.initialize(device=dev)
    mesh = make_mesh(MeshConfig(data=1))
    out = {"backend": torch.distributed.get_backend(),
           "world": distributed.process_count(),
           "nccl": (".".join(str(v) for v in torch.cuda.nccl.version())
                    if dev.type == "cuda" else "none"),
           "runs": {}}
    paths = mesh_paths()
    for label in ("MLP", "FT fused"):
        job, tr, va = paths[label]
        t0 = time.perf_counter()
        ref = param_arrays(train(job, tr, va, console=lambda s: None,
                                 device=dev).state.model)
        reset_launches()
        res = train(job, tr, va, console=lambda s: None, device=dev,
                    mesh=mesh)
        launches = read_launches()
        got = param_arrays(res.state.model)
        out["runs"][label] = {
            "launches": launches, "steps": res.state.step,
            "bitwise": all(np.array_equal(got[k], ref[k]) for k in ref),
            "close": all(np.allclose(got[k], ref[k], rtol=MESH_RTOL,
                                     atol=MESH_ATOL) for k in ref),
            "max_abs": max(float(np.max(np.abs(got[k] - ref[k])))
                           for k in ref),
            "seconds": time.perf_counter() - t0}
    # 24c: the stacked trunk as one loop, against the per-block job
    from shifu_tpu_torch.models.ft_transformer import canonicalize_params
    t0 = time.perf_counter()
    job, tr, va = pipe_path(1)
    blocks = train(job, tr, va, console=lambda s: None, device=dev)
    ref = param_arrays(blocks.state.model)
    init = param_arrays(init_state(job, tr.num_features, dev).model)
    job, tr, va = pipe_path()
    reset_launches()
    res = train(job, tr, va, console=lambda s: None, device=dev, mesh=mesh)
    launches = read_launches()
    got = canonicalize_params(param_arrays(res.state.model), job.model)
    ok, worst = moved_close(got, ref, init)
    out["stacked"] = {
        "launches": launches, "steps": res.state.step,
        "evals": steps_and_evals(job, tr.num_rows, va.num_rows, 1)[1],
        "bitwise": sorted(got) == sorted(ref) and all(
            np.array_equal(got[k], ref[k]) for k in ref),
        "close": ok and sorted(got) == sorted(ref), "max_abs": worst,
        "seconds": time.perf_counter() - t0}
    job, tr, _ = paths["MLP"]
    state = init_state(job, tr.num_features, dev, mesh=mesh)
    step = step_lib.make_train_step(job, mesh)
    from shifu_tpu_torch.data import pipeline as pipe
    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype)
    batch = to_device(wcast(next(pipe.batch_iterator(
        tr, TRAIN_BATCH, shuffle=False))), job, dev)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    deadline = time.monotonic() + MESH_CHILD_TIMEOUT_S
    while not os.path.exists(gate) and time.monotonic() < deadline:
        time.sleep(0.05)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MESH_PROFILE_STEPS):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
        kernels, ops = nccl_events(prof)
        if sum(kernels.values()) >= MESH_PROFILE_STEPS:
            break
    out["profile"] = {"kernels": kernels, "ops": ops, "attempts": attempt}
    with open(out_path, "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def gloo_rank(rank: int, store: str, out_path: str, device: str) -> None:
    """23b, one of two ranks that share cuda:0 over gloo (NCCL refuses two
    ranks of one communicator on one device).  DeepFM with the tables
    vocab-sharded over model=2, then the MLP on data=2, each through
    `train(..., mesh=)` with the launches counted; rank 0 writes the
    gathered parameters (`.npz`) beside its findings."""
    import torch
    from shifu_tpu_torch.config.schema import MeshConfig
    from shifu_tpu_torch.embed.shard import assert_vocab_sharded
    from shifu_tpu_torch.parallel import distributed, make_mesh
    from shifu_tpu_torch.train import checkpoint as ckpt_lib
    from shifu_tpu_torch.train.loop import train

    dev = torch.device(device)
    distributed.initialize(coordinator=f"file://{store}", num_processes=2,
                           process_id=rank, device=dev)
    paths = mesh_paths()
    out, arrays = {"backend": distributed.backend_choice()}, {}
    for label, cfg in (("DeepFM", MeshConfig(model=2)),
                       ("MLP", MeshConfig(data=2))):
        job, tr, va = paths[label]
        mesh = make_mesh(cfg)
        t0 = time.perf_counter()
        reset_launches()
        res = train(job, tr, va, console=lambda s: None, device=dev,
                    mesh=mesh)
        launches = read_launches()
        seconds = time.perf_counter() - t0
        rows, sum_ms = None, None
        if res.state.shardings:
            table = res.state.model.cat_embedding.embedding
            assert_vocab_sharded(table, 2, DEEPFM_VOCAB)
            rows = list(table.shape)
            # the lookup's sum over the model group, alone: the (B, Nc,
            # D + heads) bf16 partial rows a step's forward all-reduces
            part = torch.ones((job.data.batch_size, 6, 17),
                              dtype=torch.bfloat16, device=dev)
            sum_ms = time_ms(lambda: distributed.all_reduce(
                part, mesh.group("model")), reps=5, warmup=2)
        full = ckpt_lib.full_payload(res.state)["model"]  # collective
        if rank == 0:
            arrays.update({f"{label}/{k}": v.float().cpu().numpy()
                           for k, v in full.items()})
        out[label] = {"launches": launches, "steps": res.state.step,
                      "table_rows": rows, "coords": mesh.coords,
                      "valid_auc": res.history[-1].valid_auc,
                      "step_ms": [1e3 * m.epoch_time * len(res.history)
                                  / res.state.step for m in res.history],
                      "sum_ms": sum_ms, "seconds": seconds}
    # 24a: the model-side axes, on the same two ranks
    for label, (job, axes, tr, va, _) in tp_paths().items():
        mesh = make_mesh(MeshConfig(**axes))
        t0 = time.perf_counter()
        reset_launches()
        res = train(job, tr, va, console=lambda s: None, device=dev,
                    mesh=mesh)
        launches = read_launches()
        full = ckpt_lib.full_payload(res.state)["model"]  # collective
        if rank == 0:
            arrays.update({f"{label}/{k}": v.float().cpu().numpy()
                           for k, v in full.items()})
        out[label] = {
            "launches": launches, "steps": res.state.step,
            "coords": mesh.coords, "valid_auc": res.history[-1].valid_auc,
            "split": {k: [list(sh.spec), list(
                dict(res.state.model.named_parameters())[k].shape)]
                for k, sh in res.state.shardings.items()},
            "seconds": time.perf_counter() - t0}
    with open(f"{out_path}.{rank}.json", "w") as f:
        json.dump(out, f)
    if rank == 0:
        np.savez(f"{out_path}.npz", **arrays)
    distributed.barrier("23b")
    distributed.shutdown()


def pipe_rank(rank: int, store: str, out_path: str, device: str) -> None:
    """24b, one of three ranks that share cuda:0 over gloo on `pipe=3`: the
    pipelined FT through `train(..., mesh=)` with the launches counted;
    rank 0 writes the gathered parameters and the exported artifact."""
    import torch
    from shifu_tpu_torch.config.schema import MeshConfig
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.parallel import distributed, make_mesh
    from shifu_tpu_torch.train import checkpoint as ckpt_lib
    from shifu_tpu_torch.train.loop import gathered_model, train

    dev = torch.device(device)
    distributed.initialize(coordinator=f"file://{store}",
                           num_processes=MESH_PIPE_STAGES, process_id=rank,
                           device=dev)
    job, tr, va = pipe_path(dtype=LOCKSTEP_FT_DTYPE)
    mesh = make_mesh(MeshConfig(pipe=MESH_PIPE_STAGES))
    t0 = time.perf_counter()
    reset_launches()
    res = train(job, tr, va, console=lambda s: None, device=dev, mesh=mesh)
    launches = read_launches()
    seconds = time.perf_counter() - t0
    full = ckpt_lib.full_payload(res.state)["model"]  # collective
    model = gathered_model(res.state, job)            # collective
    out = {"backend": distributed.backend_choice(),
           "launches": launches, "steps": res.state.step,
           "coords": mesh.coords, "seconds": seconds,
           "valid_auc": res.history[-1].valid_auc,
           "stage_rows": list(res.state.model.blocks.qkv_kernel.shape)}
    if rank == 0:
        np.savez(f"{out_path}.npz", **{k: v.float().cpu().numpy()
                                       for k, v in full.items()})
        save_artifact(model, job.model, job.schema, f"{out_path}.artifact")
    with open(f"{out_path}.{rank}.json", "w") as f:
        json.dump(out, f)
    distributed.barrier("24b")
    distributed.shutdown()


def placed_gloo(label: str, ranks: list) -> str:
    """The backend every rank's placement chose: gloo, because all of
    `ranks` share cuda:0 (fails otherwise).  Returns it as a phrase."""
    want = {"backend": "gloo", "reason": "ranks share a card",
            "ranks_per_card": len(ranks)}
    got = [rk["backend"] for rk in ranks]
    if any(g != want for g in got):
        fail(f"{label}: the placement chose {got}, expected {want} on "
             "every rank")
    return f"gloo (ranks share a card: {len(ranks)} on it)"


def moved_close(got: dict, ref: dict, init: dict) -> tuple[bool, float]:
    """Each parameter's change from init within LOCKSTEP_MOVED_RTOL of the
    reference's (relative to its largest entry), as the card-vs-CPU
    locksteps hold it; and the largest absolute difference."""
    ok, worst = True, 0.0
    for k, r in ref.items():
        moved = np.max(np.abs(r - init[k]))
        diff = float(np.max(np.abs(got[k] - r)))
        worst = max(worst, diff)
        ok &= diff <= LOCKSTEP_MOVED_RTOL * moved + 1e-7
    return ok, worst


def join_all(procs: list, label: str) -> float:
    """Join spawned processes within MESH_CHILD_TIMEOUT_S; their exit
    codes must be 0.  Returns the seconds waited."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + MESH_CHILD_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
        fail(f"{label}: did not end in {MESH_CHILD_TIMEOUT_S} s")
    if any(p.exitcode != 0 for p in procs):
        fail(f"{label}: exited {[p.exitcode for p in procs]}")
    return time.perf_counter() - t0


def mesh_phases(device, tmp: str, smi_line: str) -> None:
    """Phases 23 and 24: the distributed path, at world 1 over NCCL (23a,
    then 24c in the same rank), as two ranks sharing the card over gloo
    (23b, then 24a in the same ranks) and as three (24b), all at once;
    23a's profile waits for the gloo ranks to end, and the world-1
    references of 23b, 24a and 24b run here after them."""
    import torch
    from shifu_tpu_torch.parallel import distributed
    from shifu_tpu_torch.parallel.launch import free_port
    from shifu_tpu_torch.train.loop import init_state, train

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    # 23a: one rank with the environment contract, NCCL
    out_a, gate = f"{tmp}/mesh_nccl.json", f"{tmp}/mesh_gloo.done"
    env = {distributed.ENV_COORDINATOR: f"127.0.0.1:{free_port()}",
           distributed.ENV_NUM_PROCESSES: "1", distributed.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        proc = ctx.Process(target=nccl_child,
                           args=(out_a, str(device), gate))
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # 23b: two ranks on cuda:0 over gloo
    out_b = f"{tmp}/mesh_gloo"
    store = f"{tmp}/mesh_gloo.store"
    procs = [ctx.Process(target=gloo_rank, args=(r, store, out_b, str(device)))
             for r in range(2)]
    # 24b: three ranks on cuda:0 over gloo, pipe=3, beside 23b
    out_p = f"{tmp}/mesh_pipe"
    pipes = [ctx.Process(target=pipe_rank,
                         args=(r, f"{tmp}/mesh_pipe.store", out_p,
                               str(device)))
             for r in range(MESH_PIPE_STAGES)]
    for p in procs + pipes:
        p.start()
    join_all(procs, "23b/24a: the gloo ranks")
    b_s = time.perf_counter() - t0
    join_all(pipes, "24b: the pipeline ranks")
    p_s = time.perf_counter() - t0
    open(gate, "w").close()
    join_all([proc], "23a: the NCCL rank")
    a_s = time.perf_counter() - t0
    if not os.path.exists(out_a):
        fail("23a: the NCCL rank wrote no findings")
    with open(out_a) as f:
        a = json.load(f)
    if a["backend"] != "nccl" or a["world"] != 1:
        fail(f"23a: backend {a['backend']} at world {a['world']}, expected "
             "nccl at world 1")
    for label, kernel in (("MLP", "int8_matmul"), ("FT fused", "ft_block")):
        run = a["runs"][label]
        if not run["close"]:
            fail(f"23a {label}: the mesh run's parameters are "
                 f"{run['max_abs']:.3e} from the run without a mesh "
                 f"(rtol {MESH_RTOL} atol {MESH_ATOL})")
        if not run["launches"].get(kernel):
            fail(f"23a {label}: {kernel} did not launch on the mesh path: "
                 f"{run['launches']}")
        say(f"23a {label}: train(..., mesh=data=1) over NCCL "
            f"{a['nccl']} at world 1, {run['steps']} steps: parameters "
            f"{'bitwise equal to' if run['bitwise'] else 'within rtol ' + str(MESH_RTOL) + ' atol ' + str(MESH_ATOL) + ' of'} "
            f"the run without a mesh (max abs {run['max_abs']:.3e}); "
            f"launches {run['launches']}; {run['seconds']:.1f} s")
    prof = a["profile"]
    if sum(prof["kernels"].values()) < MESH_PROFILE_STEPS:
        fail(f"23a: no NCCL kernel in {prof['attempts']} profiles of "
             f"{MESH_PROFILE_STEPS} mesh steps: {prof}")
    say(f"23a profile of {MESH_PROFILE_STEPS} mesh steps of the MLP: NCCL "
        f"device kernels {prof['kernels']}, NCCL host ops {prof['ops']} "
        f"(attempt {prof['attempts']}; one gradient average a step; NCCL "
        f"launches its one-rank reduce kernel for an average at world 1, "
        f"where it elides an in-place sum) [{smi_line}]")
    say(f"time: 23a NCCL at world 1 {a_s:.1f} s from spawn to exit (its "
        f"profile after 23b's and 24b's end); 23b and 24a two ranks over "
        f"gloo {b_s:.1f} s, 24b three ranks over gloo {p_s:.1f} s, all at "
        f"once")
    st = a["stacked"]
    want = {"ft_block": MESH_PIPE_STAGES * (st["steps"] + st["evals"]),
            "embedding_lookup": st["steps"] + st["evals"]}
    got_l = {k: v for k, v in st["launches"].items() if v}
    if got_l != want:
        fail(f"24c: launches {got_l}, expected {want}")
    if not st["close"]:
        fail(f"24c: the stacked trunk's canonicalized parameters differ "
             f"from the per-block run's beyond {LOCKSTEP_MOVED_RTOL} of "
             f"each change (max abs {st['max_abs']:.3e})")
    say(f"24c stacked trunk (pipeline_stages={MESH_PIPE_STAGES}, no pipe "
        f"axis) through train(..., mesh=data=1) over NCCL at world 1, "
        f"{st['steps']} steps at batch {MESH_PIPE_BATCH}: launches {got_l}; "
        f"canonicalized parameters "
        + ("bitwise equal to" if st["bitwise"] else
           f"within {LOCKSTEP_MOVED_RTOL} of each change of")
        + f" the per-block run from the same seed (max abs "
        f"{st['max_abs']:.3e}); {st['seconds']:.1f} s for both runs "
        f"[{smi_line}]")

    # 23b's findings, against world-1 runs here
    ranks = []
    for r in range(2):
        with open(f"{out_b}.{r}.json") as f:
            ranks.append(json.load(f))
    with np.load(f"{out_b}.npz") as z:
        gathered = {k: z[k] for k in z.files}
    placed = placed_gloo("23b", ranks)
    paths = mesh_paths()
    for label, want_launch in (
            ("DeepFM", lambda st, ev: {"embedding_lookup": st + ev,
                                       "rows_update": 2 * st}),
            ("MLP", lambda st, ev: {"int8_matmul": st + ev})):
        job, tr, va = paths[label]
        init = param_arrays(init_state(job, tr.num_features, device).model)
        res = train(job, tr, va, console=lambda s: None, device=device)
        ref = param_arrays(res.state.model)
        got = {k[len(label) + 1:]: v for k, v in gathered.items()
               if k.startswith(label + "/")}
        ok, worst = moved_close(got, ref, init)
        if not ok or sorted(got) != sorted(ref):
            fail(f"23b {label}: the two ranks' parameters differ from the "
                 f"world-1 run's beyond {LOCKSTEP_MOVED_RTOL} of each "
                 f"parameter's change (max abs {worst:.3e})")
        steps, evals = steps_and_evals(job, tr.num_rows, va.num_rows,
                                       job.train.epochs)
        if ranks[0][label]["steps"] != steps:
            fail(f"23b {label}: {ranks[0][label]['steps']} steps, expected "
                 f"{steps}")
        want = want_launch(steps, evals)
        for r, rk in enumerate(ranks):
            got_l = {k: v for k, v in rk[label]["launches"].items() if v}
            if got_l != want:
                fail(f"23b {label} rank {r}: launches {got_l}, expected "
                     f"{want}")
        rows = [rk[label]["table_rows"] for rk in ranks]
        if label == "DeepFM" and rows != [[6, DEEPFM_VOCAB // 2, 16]] * 2:
            fail(f"23b DeepFM: table slices {rows}, expected "
                 f"V/2 = {DEEPFM_VOCAB // 2} rows on each rank")
        say(f"23b {label} on {ranks[0][label]['coords']} / "
            f"{ranks[1][label]['coords']} (two ranks on cuda:0 over "
            f"{placed}, by the placement): {steps} steps, launches per "
            f"rank {want}"
            + (f", each rank's tables {rows[0]} of "
               f"[6, {DEEPFM_VOCAB}, 16]" if label == "DeepFM" else "")
            + f"; parameters within {LOCKSTEP_MOVED_RTOL} of each change of "
            f"the world-1 run (max abs {worst:.3e}); valid_auc "
            f"{ranks[0][label]['valid_auc']:.4f} against "
            f"{res.history[-1].valid_auc:.4f}; ms a step by epoch (its wall "
            f"over its steps, host clock; epoch 0 pays the rank's first "
            f"use) "
            f"{[round(v, 1) for v in ranks[0][label]['step_ms']]} against "
            f"{[round(1e3 * m.epoch_time * len(res.history) / res.state.step, 1) for m in res.history]}"
            f" at world 1"
            + (f"; the lookup's sum over model=2 alone "
               f"{ranks[0][label]['sum_ms']:.2f} ms (CUDA events)"
               if ranks[0][label]["sum_ms"] is not None else "")
            + f"; {ranks[0][label]['seconds']:.1f} s a rank; gloo carried "
            f"every collective on CUDA tensors (no host staging of the "
            f"port's own)")
    lap("23a and 23b, and 23b's world-1 references")
    seq_tp_phase(device, ranks, gathered, smi_line)
    pipe_phase(device, tmp, out_p, smi_line)
    lap("24a and 24b's world-1 references")


def seq_tp_phase(device, ranks: list, gathered: dict, smi_line: str) -> None:
    """24a's findings (in 23b's ranks' files) against world-1 runs here."""
    from shifu_tpu_torch.train.loop import init_state, train

    for label, (job, axes, tr, va, want_launch) in tp_paths().items():
        init = param_arrays(init_state(job, tr.num_features, device).model)
        res = train(job, tr, va, console=lambda s: None, device=device)
        ref = param_arrays(res.state.model)
        got = {k[len(label) + 1:]: v for k, v in gathered.items()
               if k.startswith(label + "/")}
        ok, worst = moved_close(got, ref, init) if sorted(got) == sorted(
            ref) else (False, float("nan"))
        if not ok:
            fail(f"24a {label}: the two ranks' parameters differ from the "
                 f"world-1 run's beyond {LOCKSTEP_MOVED_RTOL} of each "
                 f"parameter's change (max abs {worst:.3e})")
        steps, evals = steps_and_evals(job, tr.num_rows, va.num_rows, 1)
        want = want_launch(steps, evals)
        for r, rk in enumerate(ranks):
            run = rk[label]
            if run["steps"] != steps:
                fail(f"24a {label}: {run['steps']} steps, expected {steps}")
            got_l = {k: v for k, v in run["launches"].items() if v}
            if got_l != want:
                fail(f"24a {label} rank {r}: launches {got_l}, expected "
                     f"{want}")
        split = ranks[0][label]["split"]
        if "seq" not in axes and not split:
            fail(f"24a {label}: no parameter split over {axes}")
        say(f"24a {label} on {axes} (two ranks on cuda:0 over gloo): "
            f"{steps} steps, launches per rank {want or 'none'}; split "
            f"leaves (spec, rank 0's block) {split or 'none'}; parameters "
            f"within {LOCKSTEP_MOVED_RTOL} of each change of the world-1 "
            f"run (max abs {worst:.3e}); valid_auc "
            f"{ranks[0][label]['valid_auc']:.4f} against "
            f"{res.history[-1].valid_auc:.4f}; "
            f"{ranks[0][label]['seconds']:.1f} s a rank [{smi_line}]")


def pipe_phase(device, tmp: str, out_p: str, smi_line: str) -> None:
    """24b's findings against the stacked trunk at world 1 here, and the
    two exported artifacts scored on the card."""
    from shifu_tpu_torch.export.artifact import save_artifact
    from shifu_tpu_torch.export.scorer import TorchScorer
    from shifu_tpu_torch.train.loop import init_state, train

    ranks = []
    for r in range(MESH_PIPE_STAGES):
        with open(f"{out_p}.{r}.json") as f:
            ranks.append(json.load(f))
    with np.load(f"{out_p}.npz") as z:
        got = {k: z[k] for k in z.files}
    placed = placed_gloo("24b", ranks)
    job, tr, va = pipe_path(dtype=LOCKSTEP_FT_DTYPE)
    init = param_arrays(init_state(job, tr.num_features, device).model)
    res = train(job, tr, va, console=lambda s: None, device=device)
    ref = param_arrays(res.state.model)
    ok, worst = moved_close(got, ref, init) if sorted(got) == sorted(
        ref) else (False, float("nan"))
    if not ok:
        fail(f"24b: the pipeline's parameters differ from the world-1 "
             f"stacked run's beyond {LOCKSTEP_MOVED_RTOL} of each change "
             f"(max abs {worst:.3e})")
    steps, evals = steps_and_evals(job, tr.num_rows, va.num_rows, 1)
    want = {"ft_block": MESH_PIPE_STAGES * (steps + evals),
            "embedding_lookup": steps + evals}
    for r, rk in enumerate(ranks):
        got_l = {k: v for k, v in rk["launches"].items() if v}
        if rk["steps"] != steps or got_l != want:
            fail(f"24b rank {r}: {rk['steps']} steps, launches {got_l}; "
                 f"expected {steps} and {want}")
        if rk["stage_rows"][0] != 1:
            fail(f"24b rank {r}: stage holds {rk['stage_rows']} of the "
                 "stacked qkv kernel, expected one layer")
    one = save_artifact(res.state.model, job.model, job.schema,
                        f"{tmp}/mesh_pipe_world1")
    rows = synthetic_datasets(job.schema, PROBE_ROWS, 1,
                              SEED + 10)[0].features
    a = TorchScorer(f"{out_p}.artifact", device=device).compute_batch(rows)
    b = TorchScorer(one, device=device).compute_batch(rows)
    diff = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    if not diff <= SERVE_ATOL:
        fail(f"24b: the pipelined artifact's scores are {diff:.3e} from the "
             f"world-1 artifact's (SERVE_ATOL {SERVE_ATOL})")
    say(f"24b pipe={MESH_PIPE_STAGES} (three ranks on cuda:0 over "
        f"{placed}, by the placement), batch {MESH_PIPE_BATCH} in "
        f"{MESH_PIPE_STAGES} microbatches: {steps} steps, launches per "
        f"rank {want} (each stage runs its layer on its 3 microbatches "
        f"only, the bubble ticks skipped); parameters within "
        f"{LOCKSTEP_MOVED_RTOL} of each change of the stacked trunk at "
        f"world 1 (max abs {worst:.3e}); valid_auc "
        f"{ranks[0]['valid_auc']:.4f} against "
        f"{res.history[-1].valid_auc:.4f}; the exported per-block "
        f"artifact's scores {diff:.3e} from the world-1 artifact's on "
        f"{PROBE_ROWS} rows; {ranks[0]['seconds']:.1f} s a rank "
        f"[{smi_line}]")


# -- phase 25: the pod on the card --------------------------------------------

POD_EPOCHS = 2
POD_TIMEOUT_S = 300
# the children's sitecustomize: before every chaos probe (the loop's epoch
# starts, a chaos exit among them) and at exit, each process that trains
# writes its kernel counts to <CHIP_SMOKE_POD_COUNTS>/<pid>.json
POD_SITE = '''
import atexit, json, os, sys
_dir = os.environ.get("CHIP_SMOKE_POD_COUNTS")
if _dir:
    def _write():
        ops = sys.modules.get("shifu_tpu_torch.ops")
        if ops is None:
            return
        rec = {"rank": os.environ.get("SHIFU_TPU_PROCESS_ID"),
               "launches": {k: fn.launches
                            for k, fn in ops.launch_counters().items()}}
        path = os.path.join(_dir, f"{os.getpid()}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
    from shifu_tpu_torch import chaos as _chaos
    _probe = _chaos.maybe_fail

    def _counted_probe(*a, **k):
        _write()
        return _probe(*a, **k)
    _chaos.maybe_fail = _counted_probe
    atexit.register(_write)
'''
# Cloud TPU's control surface, faked: a slice of two workers at 127.0.0.1
POD_GCLOUD = '''#!{python}
import json, os, sys
with open(os.environ["CHIP_SMOKE_GCLOUD_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + chr(10))
cmd = " ".join(sys.argv[1:])
if "queued-resources describe" in cmd:
    print(json.dumps({{"state": {{"state": "ACTIVE"}}}}))
elif "tpu-vm describe" in cmd:
    print(json.dumps({{"networkEndpoints": [{{"ipAddress": "127.0.0.1"}},
                                            {{"ipAddress": "127.0.0.1"}}]}}))
elif "queued-resources" not in cmd:
    sys.exit(64)
'''
# an ssh that runs the remote command here, keeping the job dir's
# provision marker as it stood when the gang was dispatched
POD_SSH = '''#!/bin/sh
[ "$1" = -tt ] || {{ echo 'missing -tt' >&2; exit 64; }}
shift
[ "$1" = -o ] && shift 2
shift
cp {marker} {seen} 2>/dev/null
exec sh -c "$*"
'''


def pod_env(tmp: str, counts: str) -> dict:
    """The pod's environment: the fake gcloud and ssh first on PATH, the
    counting sitecustomize and the repo on PYTHONPATH, no SHIFU_TPU_*."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(counts, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SHIFU_TPU_")}
    env.update(PYTHONPATH=os.pathsep.join((f"{tmp}/pod_site", root)),
               PATH=f"{tmp}/pod_bin{os.pathsep}{env.get('PATH', '')}",
               CHIP_SMOKE_POD_COUNTS=counts,
               CHIP_SMOKE_GCLOUD_LOG=f"{tmp}/pod_gcloud.log")
    return env


def pod_counts(counts: str) -> list:
    """Each training process's kernel counts (its rank and launches)."""
    out = []
    for name in sorted(os.listdir(counts)):
        if name.endswith(".json"):
            with open(os.path.join(counts, name)) as f:
                out.append(json.load(f))
    return out


def check_pod_launches(label: str, counts: list, want: int,
                       processes: int) -> None:
    """Every rank process launched #4 `want` times and no other kernel
    (a dispatcher, which has no rank, launched none)."""
    got = [(c["rank"], c["launches"]) for c in counts
           if c["rank"] is not None]
    idle = [c["launches"] for c in counts if c["rank"] is None]
    if len(got) != processes or any(sum(n.values()) for n in idle) or any(
            n["int8_matmul"] != want or sum(n.values()) != want
            for _, n in got):
        fail(f"{label}: launches {got}: expected {processes} rank "
             f"processes, each with int8_matmul {want} (train steps + eval "
             "batches) and no other kernel")


def pod_phases(device, tmp: str, smi_line: str) -> None:
    """25: the pod on the card, three runs at once on phase 8's 16 gzip
    parts of the headline MLP (the int8 wire, the staged tier, the cache
    hot, global batch 65536): 25a `train --hosts local:2`, 25b the same
    with rank 1 killed at `data.host_shard` in epoch 1, 25c `train
    --provision` over a fake gcloud and ssh for 1 epoch."""
    import dataclasses as dc

    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.launcher import cli, pod
    from shifu_tpu_torch.obs import timeline
    from shifu_tpu_torch.parallel.launch import free_port

    t_phase = time.perf_counter()
    os.makedirs(f"{tmp}/pod_site")
    with open(f"{tmp}/pod_site/sitecustomize.py", "w") as f:
        f.write(POD_SITE)
    os.makedirs(f"{tmp}/pod_bin")
    for name, text in (("gcloud", POD_GCLOUD.format(python=sys.executable)),
                       ("ssh", POD_SSH.format(
                           marker=f"{tmp}/pod_c/provision.json",
                           seen=f"{tmp}/pod_marker_seen"))):
        with open(f"{tmp}/pod_bin/{name}", "w") as f:
            f.write(text)
        os.chmod(f"{tmp}/pod_bin/{name}", 0o755)
    xml = cli_xml(tmp, "pod", {"cache-dir": f"{tmp}/cli_cache"})
    data_dir = f"{tmp}/cli_data"

    def argv(out: str, epochs: int) -> list:
        return cli_argv(tmp, data_dir, xml, f"{tmp}/{out}", device) + [
            "--epochs", str(epochs)]

    kill_plan = {"faults": [{"site": "data.host_shard", "rank": 1,
                             "at_epoch": 1, "action": "exit",
                             "exit_code": 23, "scope": "job",
                             "max_times": 1}]}
    runs = {"25a": argv("pod_a", POD_EPOCHS) + ["--hosts", "local:2"],
            "25b": argv("pod_b", POD_EPOCHS) + [
                "--hosts", "local:2", "--chaos-plan", json.dumps(kill_plan)],
            "25c": argv("pod_c", 1) + [
                "--provision", "--provision-name", "chip-smoke-pod",
                "--accelerator-type", "v5litepod-8", "--zone", "us-west4-a",
                "--coordinator-port", str(free_port())]}
    procs = {}
    for label, args in runs.items():
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", "shifu_tpu_torch.launcher.cli", *args],
            env=pod_env(tmp, f"{tmp}/pod_counts_{label[-1]}"),
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter())
    # meanwhile, each host's shard as its ranks load it: the steps and eval
    # batches every rank must launch #4 for
    job = cli._assemble_job(cli.build_parser().parse_args(
        runs["25a"]), write_files=False)[0]
    data = dc.replace(job.data, cache_dir=f"{tmp}/cli_cache")
    fd = f"int8c{job.data.wire_int8_clip:g}"
    shards = [pipe.load_datasets(job.schema, data, h, 2, feature_dtype=fd)
              for h in range(2)]
    local_bs = TRAIN_BATCH // 2
    steps = min(tr.num_rows for tr, _ in shards) // local_bs
    evals = max(-(-va.num_rows // local_bs) for _, va in shards)
    del shards
    outs = {}
    for label, (proc, t0) in procs.items():
        try:
            stdout, _ = proc.communicate(timeout=POD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p, _ in procs.values():
                p.kill()
            fail(f"{label}: the pod did not end within {POD_TIMEOUT_S} s")
        if proc.returncode != 0:
            fail(f"{label}: the pod exited {proc.returncode}: "
                 f"{stdout[-3000:]}")
        out = f"{tmp}/pod_{label[-1]}"
        with np.load(f"{out}/final_model/weights.npz") as z:
            weights = {k: z[k] for k in z.files}
        outs[label] = {"stdout": stdout, "wall_s": time.perf_counter() - t0,
                       "journal": journal(f"{out}/telemetry"),
                       "merged": timeline.load_merged(out, tail_bytes=None),
                       "weights": weights,
                       "counts": pod_counts(f"{tmp}/pod_counts_{label[-1]}")}

    per_epoch = steps + evals
    check_pod_launches("25a", outs["25a"]["counts"], POD_EPOCHS * per_epoch,
                       2)
    check_pod_launches("25b", outs["25b"]["counts"], per_epoch, 4)
    check_pod_launches("25c", outs["25c"]["counts"], per_epoch, 2)
    reports = {}
    for label, run in outs.items():
        dcn = [e for e in run["journal"] if e["kind"] == "dcn_placement"]
        if not dcn or any((e["backend"], e["hosts"], e["ranks"])
                          != ("gloo", 2, 2) for e in dcn) \
                or "backend=gloo (ranks share a card)" not in run["stdout"]:
            fail(f"{label}: dcn_placement {dcn[:1]}: expected two hosts on "
                 "gloo, chosen because the ranks share a card")
        reports[label] = pod.pod_verify_events(run["merged"]["events"])
        if reports[label]["verdict"] != "PASS":
            fail(f"{label}: pod-verify {reports[label]}")
    recovery = [c for c in reports["25b"]["checks"]
                if c["check"] == "recovery"]
    if (reports["25b"]["counts"]["injections"] != 1 or not recovery
            or not recovery[0]["ok"]
            or "pod: succeeded after 2 attempts" not in
            outs["25b"]["stdout"]):
        fail(f"25b: pod-verify {reports['25b']}, output "
             f"{outs['25b']['stdout'][-2000:]}: expected one injection, "
             "recovery and one gang restart")
    a, b = outs["25a"], outs["25b"]
    if journal_losses(a["journal"]) != journal_losses(b["journal"]) or \
            sorted(a["weights"]) != sorted(b["weights"]) or not all(
                np.array_equal(a["weights"][k], b["weights"][k])
                for k in a["weights"]):
        fail(f"25b: per-epoch losses {journal_losses(b['journal'])} or "
             f"final_model against 25a's {journal_losses(a['journal'])}")
    with open(f"{tmp}/pod_gcloud.log") as f:
        calls = [json.loads(ln) for ln in f]
    seen = f"{tmp}/pod_marker_seen"
    if (not os.path.exists(seen) or os.path.exists(
            f"{tmp}/pod_c/provision.json")
            or [c[3] for c in calls[:1] + calls[-1:]] != ["create", "delete"]
            or "provision: released chip-smoke-pod" not in
            outs["25c"]["stdout"]):
        fail(f"25c: gcloud calls {calls}, marker seen "
             f"{os.path.exists(seen)}: expected the marker during the run, "
             "gone after, and the slice deleted")

    def samples(run: dict) -> str:
        return ", ".join(
            f"epoch {e['epoch']} {steps * TRAIN_BATCH / e['epoch_time']:.1f}"
            for e in run["journal"] if e["kind"] == "epoch")
    say(f"25 pod: two hosts (local ranks on cuda:0, gloo: the ranks share "
        f"the card), each its 8 of phase 8's 16 parts, {steps} steps of "
        f"{local_bs} rows a rank and {evals} eval batches an epoch; every "
        f"rank launched #4 steps + evals times and no other kernel; "
        f"25a {a['wall_s']:.1f} s, samples/s {samples(a)}; 25b (rank 1 "
        f"killed at data.host_shard in epoch 1, one gang restart, pod-verify "
        f"recovery) {b['wall_s']:.1f} s, losses and final_model bitwise "
        f"25a's, samples/s {samples(b)}; 25c (train --provision, the fake "
        f"gcloud's {len(calls)} calls from create to delete, the marker "
        f"there during the run and gone after) "
        f"{outs['25c']['wall_s']:.1f} s, samples/s {samples(outs['25c'])}; "
        f"pod-verify PASS on each; phase {time.perf_counter() - t_phase:.1f}"
        f" s [{smi_line}]")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from shifu_tpu_torch.export.artifact import save_artifact
        from shifu_tpu_torch.models.registry import build_model
        from shifu_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port ({e}): run from the repo root")

    # phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    if smi.returncode != 0 or not smi_line:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"device: {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible; host: "
        f"{len(os.sched_getaffinity(0))} CPUs, {torch.get_num_threads()} "
        "torch threads")
    say(smi_line)
    say(read_sm_clock())
    device = torch.device("cuda:0")

    # phase 2: build (one nvcc per source) while the CPU halves of the
    # locksteps run in a process of their own; that process has ended
    # before the first profile: profiles taken while it lived, even idle,
    # now and then lost their first device events, in one run more than
    # half of a kernel's in every retake
    pool = multiprocessing.get_context("spawn").Pool(1)
    pending = pool.apply_async(cpu_lockstep_refs)
    try:
        build_s = _build.build_all()
    except Exception as e:  # noqa: BLE001 — reported as the phase's failure
        fail(f"build: {e}")
    # one cuobjdump a source, all at once (each reads a whole library),
    # behind the CPU halves' end and the profiler's warm-up
    from concurrent.futures import ThreadPoolExecutor
    sass_srcs = [src for src in sorted(_build.build_logs)
                 if src.startswith("flash_") or src in SASS_OPS]
    sass_pool = ThreadPoolExecutor(len(sass_srcs) or 1)
    sass_jobs = {src: sass_pool.submit(build_report, src)
                 for src in sass_srcs}
    try:
        cpu_refs = pending.get(timeout=900)
    except Exception as e:  # noqa: BLE001 — reported as the phase's failure
        fail(f"the CPU halves of the FT locksteps failed: {e!r}")
    pool.close()
    pool.join()
    warm_profiler(device)
    reports = {src: job.result() for src, job in sass_jobs.items()}
    sass_pool.shutdown()
    for src in sorted(_build.build_logs):
        if src in reports:
            line, counts = reports[src]
            say(f"build: {src}: " + line)
            if src == "ft_block" and any(
                    not c["HMMA"] or c["MUFU.TANH"] for c in counts.values()):
                fail("build: an ft_block instantiation has no HMMA (the "
                     "products must run on the tensor cores) or has "
                     "MUFU.TANH (tanh.approx)")
            if src == "small_attention":
                check_small_attention_build(counts)
            if src == "int8_matmul":
                check_int8_build(counts)
            if src == "rows_update":
                check_rows_build(counts)
            continue
        usage = [ln.strip() for ln in _build.build_logs[src].splitlines()
                 if "registers" in ln or "spill" in ln]
        say(f"build: {src}: " + " | ".join(usage))
    say(f"build: {len(_build.sources())} kernels in {build_s:.2f} s")
    lap("device, build, the CPU halves of the locksteps")

    # phase 3: kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    kernels = []
    for check in (check_ft_block, check_small_attention,
                  check_small_attention_bwd, check_int8_matmul,
                  check_embedding_lookup, check_rows_update, check_flash):
        got = check(device, gen)
        kernels.extend(got if isinstance(got, list) else [got])
        lap(check.__name__)
    say("profiler: {lost} device events lost and {seen} seen over "
        "{profiles} profiles of the kernel checks (each time counts the "
        "events it saw: see device_ms)".format(**PROFILE_EVENTS))

    # phases 4 and 5: serve the full-width artifact, fused then unfused
    schema = serving_schema()
    spec = ft_serving_spec("auto")
    model = build_model(spec, schema, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="shifu_chip_smoke_") as tmp:
        fused_dir = save_artifact(model, spec, schema, f"{tmp}/fused")
        res = serve_phase("fused", fused_dir, schema, rng, device)
        report_serve("fused", res)
        want = {"ft_block": spec.num_layers * res["dispatched"],
                "embedding_lookup": res["dispatched"]}
        if res["launches"] != {k: want.get(k, 0) for k in res["launches"]}:
            fail(f"fused path: launches {res['launches']}, expected "
                 f"num_layers x batches and one lookup a batch = {want} "
                 "and no other kernel")

        off_spec = dataclasses.replace(spec, fused_block="off")
        off_dir = save_artifact(model, off_spec, schema, f"{tmp}/unfused")
        res = serve_phase("unfused", off_dir, schema, rng, device)
        report_serve("unfused", res)
        want = {"small_attention": spec.num_layers * res["dispatched"],
                "embedding_lookup": res["dispatched"]}
        if res["launches"] != {k: want.get(k, 0) for k in res["launches"]}:
            fail(f"unfused path: launches {res['launches']}, expected "
                 f"num_layers x batches and one lookup a batch = {want} "
                 "and no other kernel")

        profile_serve("fused", fused_dir, schema, rng, device)
        profile_serve("unfused", off_dir, schema, rng, device)
        lap("serve and profile")

        # phases 6 to 10: train the headline MLP on the int8 wire
        training_phases(device, tmp, kernels, smi_line)
        # phases 11 to 13: train the FT-Transformer on both attention paths
        ft_training_phases(device, tmp, kernels, cpu_refs)
        # phases 14 to 19: train and serve Wide&Deep and DeepFM
        embedding_training_phases(device, tmp, kernels, cpu_refs)
        # phases 20a to 20d: the flight recorder, FLOPs and MFU
        flight_recorder_phases(device, tmp)
        # phases 21a to 21d: multitask and MoE, the wire path, drift, SLO
        serving_plane_phases(device, tmp, smi_line)
        # phases 22a to 22c: the scoring tiers, cold start, the commands
        artifact_tier_phases(device, tmp, smi_line)
        # phases 22d to 22f: the views, detached jobs, tiering
        operator_phases(device, tmp, smi_line)
        # phases 22g and 22h: the serving fleet
        fleet_phases(device, tmp, smi_line)
        # phases 23 and 24: data-, vocab-, tensor-, sequence- and
        # pipeline-parallel training on torch.distributed
        mesh_phases(device, tmp, smi_line)
        # phase 25, the pod, ran beside 8d (cli_phases)

    missing = [kr["name"] for kr in kernels if not kr.get("launches")]
    if missing:
        fail(f"kernels not launched on their training path: {missing}")
    say(f"time: total {time.perf_counter() - _T0:.1f} s")
    # the kernels line, the card's line and the result line
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    say(json.dumps({"kernels": [{k: kr[k] for k in order}
                                for kr in kernels]}))
    say(smi_line)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
