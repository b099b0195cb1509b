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
               `job_config_from_shifu` and `train` on the per-batch tier
               (`device_resident_bytes=0`); the kernel launches there too.
9. serve    — the trained headline model saved with `save_artifact` and served
   trained    by the daemon on the card, checked against the CPU scorer.
10. profile — one steady-state training epoch (epoch 1, its steps and its
               eval) under torch.profiler: busy share, top kernels, a Chrome
               trace in chiprun_out/.
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
               epoch) on the per-batch tier with dedup and the sparse
               update: #5 launches steps + eval batches, #6 2 x steps (two
               tables); samples/s, eval seconds, the dedup ratio, the peak
               device memory.
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
20. a JSON line {"kernels": [...]} with each kernel's launches on its
   training path (FT fused for #1, FT unfused for #2 and #3, the headline
   MLP for #4, DeepFM for #5 and #6, FT flash for #7 and #8), its error
   against the plain version, its times and its bound; every kernel must
   have launched there.
21. the last line: {"ok": true, "device": {...}}.

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
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12       # CUDA cores, f32
PEAK_16BIT_FLOPS = 989e12    # tensor cores, bf16 and f16
PEAK_HBM_BYTES = 3.35e12

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


_LAP = [time.perf_counter()]


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
    peak = (PEAK_16BIT_FLOPS if dtype in (torch.bfloat16, torch.float16)
            else PEAK_F32_FLOPS)
    terms = [(n_bytes / PEAK_HBM_BYTES * 1e3, "bytes"),
             (n_ops / peak * 1e3, "operations")]
    if n_exp:
        if not SFU["clock_hz"]:
            fail("bound_ms: the SM clock was not read (read_sm_clock)")
        rate = SFU["sms"] * EX2_PER_CLOCK_PER_SM * SFU["clock_hz"]
        terms.append((n_exp / rate * 1e3, "exponentials"))
    return max(terms, key=lambda t: t[0])


def device_events(prof) -> list:
    """(name, device µs, count) of the device-side events of a profile:
    kernels, copies, memsets.  A CPU op's self device time repeats the
    time of the kernels it launched, so CPU ops are left out."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


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


def ft_block_ops(b: int, s: int, d: int, h: int,
                 r: int) -> tuple[float, float]:
    """Operations of one block on these shapes: (the four products, the
    rest: the attention products and the elementwise work, LayerNorm
    ~8/elt, gelu ~10/elt, softmax ~4 per score, residual adds)."""
    m = b * s
    products = 2 * m * (3 * d * d + d * d + 2 * r * d * d)
    attention = 4 * b * h * s * s * (d // h)
    elementwise = 2 * 8 * m * d + 10 * m * r * d + 4 * b * h * s * s + 2 * m * d
    return float(products), float(attention + elementwise)


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
    n_bytes = 2 * x.numel() * 4 + sum(t.numel() for t in p.values()) * 4
    products, rest = ft_block_ops(b, s, d, h, r)
    terms = [(n_bytes / PEAK_HBM_BYTES * 1e3, "bytes"),
             (FT_SPLIT_PASSES * products / PEAK_16BIT_FLOPS * 1e3,
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
    n_bytes = 4 * q.numel() * q.element_size()
    n_ops = 4.0 * b * h * s * s * d + 4.0 * b * h * s * s
    n_exp = float(b * h) * s * s
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
    n_bytes = 7 * q.numel() * q.element_size()
    n_ops = 10.0 * b * h * s * s * d
    n_exp = float(b * h) * s * s
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
        out = subprocess.run([tool, "-sass", _build._target(src)],
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
    elt = q.element_size()
    bh_s = b * h * s
    pairs = float(b * h) * s * s
    tol_text = (f"out one bf16 ulp (2^-7*|ref|+1e-6), lse {F32_ATOL:g}+"
                f"{F32_RTOL:g}*|ref|, grads {grad_tolerance(q.dtype)[2]}")
    specs = (
        ("flash_fwd", "fwd", "shifu_tpu/ops/pallas_attention.py:198",
         lambda: fa.flash_fwd(q, k, v, scale),
         lambda: fa.flash_fwd_plain(q, k, v, scale),
         4 * q.numel() * elt + bh_s * 4, 4.0 * pairs * d, sdpa_fwd_ms),
        ("flash_bwd_dq", "dq", "shifu_tpu/ops/pallas_attention.py:243",
         lambda: fa.flash_bwd_dq(q, k, v, g, lse, dres, scale),
         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, dres, scale),
         5 * q.numel() * elt + 2 * bh_s * 4, 6.0 * pairs * d, sdpa_grad_ms),
        ("flash_bwd_dkv", "dkv", "shifu_tpu/ops/pallas_attention.py:258",
         lambda: fa.flash_bwd_dkv(q, k, v, g, lse, dres, scale),
         lambda: fa.flash_bwd_dkv_plain(q, k, v, g, lse, dres, scale),
         6 * q.numel() * elt + 2 * bh_s * 4, 8.0 * pairs * d, sdpa_grad_ms))
    entries = []
    for name, key, replaces, kernel, plain, n_bytes, n_ops, lib_ms in specs:
        ms = queued_ms(kernel)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        bnd, by = bound_ms(n_bytes, n_ops, q.dtype, pairs)
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
    n_bytes = m * f + f * n * 4 + n * 4 + f * 4 + m * n * 2
    bnd, by = bound_ms(n_bytes, 2.0 * m * f * n, torch.bfloat16)
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
    n_bytes = 2 * b * nc * d * table.element_size() + ids.numel() * 4
    bnd, by = bound_ms(n_bytes, 0.0, table.dtype)
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
    n_bytes = touched * 7 * d * 4 + ids.numel() * 4
    bnd, by = bound_ms(n_bytes, 0.0, torch.float32)
    bnd_d1, _ = bound_ms(touched * 7 * 4 + ids.numel() * 4, 0.0,
                         torch.float32)
    # the raw batch's bound counts its distinct rows once: the touched rows
    # of its deduped batch
    bnd_raw, _ = bound_ms(touched * 7 * d * 4 + raw.numel() * 4, 0.0,
                          torch.float32)
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
    from shifu_tpu_torch.ops import flash_attention as fa
    from shifu_tpu_torch.ops.embedding import (embedding_lookup,
                                               fused_rows_update)
    from shifu_tpu_torch.ops.ft_block import fused_transformer_block
    from shifu_tpu_torch.ops.int8_matmul import int8_matmul_dequant
    from shifu_tpu_torch.ops.small_attention import (small_attention_bwd,
                                                     small_token_attention)
    return {"ft_block": fused_transformer_block,
            "small_attention": small_token_attention,
            "small_attention_bwd": small_attention_bwd,
            "int8_matmul": int8_matmul_dequant,
            "embedding_lookup": embedding_lookup,
            "rows_update": fused_rows_update,
            "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv}


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


def shifu_files_run(tmp: str, device) -> None:
    """The Shifu user's entry point: ModelConfig.json + ColumnConfig.json +
    gzip part files -> job_config_from_shifu -> train, on the per-batch
    tier (device_resident_bytes=0)."""
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
    # the datasets train() loads, loaded again to count the launches
    train_ds, valid_ds = pipe.load_datasets(
        job.schema, job.data, feature_dtype=f"int8c{job.data.wire_int8_clip:g}")
    _, launches = run_training("shifu", job, train_ds, valid_ds, device,
                               want_tier="batch",
                               want_launches=int8_launches(job))
    reset_launches()
    from shifu_tpu_torch.train.loop import train
    res = train(job, console=lambda ln: None, device=device)
    if read_launches() != launches or res.tier != "batch":
        fail(f"shifu: train(job) from the files launched {read_launches()} "
             f"on the {res.tier!r} tier, the loaded datasets {launches} on "
             "'batch'")
    say(f"shifu: job_config_from_shifu({SHIFU_ROWS} rows in 4 gzip parts) "
        f"-> {job.model.model_type} {job.model.hidden_nodes}, batch "
        f"{job.data.batch_size}, {job.train.optimizer.name}; train(job) "
        f"from the files on the per-batch tier launched the int8 kernel "
        f"{launches['int8_matmul']} times")


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


def training_phases(device, tmp: str, kernels: list) -> None:
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

    export_dir = save_artifact(res.state.model, job.model, job.schema,
                               f"{tmp}/trained_mlp")
    served = serve_phase("trained", export_dir, job.schema,
                         np.random.default_rng(SEED), device)
    report_serve("trained", served)
    profile_training("train", job, train_ds, valid_ds, device)
    lap("serve trained and profile train")


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
    try:
        cpu_refs = pending.get(timeout=900)
    except Exception as e:  # noqa: BLE001 — reported as the phase's failure
        fail(f"the CPU halves of the FT locksteps failed: {e!r}")
    pool.close()
    pool.join()
    warm_profiler(device)
    for src in sorted(_build.build_logs):
        if src.startswith("flash_") or src in SASS_OPS:
            line, counts = build_report(src)
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
        training_phases(device, tmp, kernels)
        # phases 11 to 13: train the FT-Transformer on both attention paths
        ft_training_phases(device, tmp, kernels, cpu_refs)
        # phases 14 to 19: train and serve Wide&Deep and DeepFM
        embedding_training_phases(device, tmp, kernels, cpu_refs)

    missing = [kr["name"] for kr in kernels if not kr.get("launches")]
    if missing:
        fail(f"kernels not launched on their training path: {missing}")
    # phase 20: the kernels line; phase 21: the result line
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
