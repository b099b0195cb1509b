#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`shifu_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero with the reason on
stderr, and no result line is printed):

1. device   — CUDA must be present; prints the card's name and
               `nvidia-smi --query-gpu=name,power.limit` on a line of its own.
2. build    — builds the CUDA kernels from shifu_tpu_torch/csrc (one nvcc per
               source, all started together) and prints the build seconds.
3. kernels  — each kernel against its plain PyTorch version on the card, at
               the shapes its path gives it and at edge shapes, with the
               tolerance stated beside each check; device times (the
               profiler's kernel durations per call) of kernel, plain
               version and, for attention, `scaled_dot_product_attention`
               as a yardstick, with the median whole-call times (CUDA
               events) beside them; the least time the card could take
               (bound: bytes over the memory rate or operations over the
               peak for the compute dtype).
4. serve    — a full-width FT-Transformer artifact (token_dim 64, 3 layers,
   fused      8 heads, mlp_ratio 4, 30 features of which 6 categorical with
               vocab 1000, bf16 compute; random weights from a seeded
               torch.Generator) served by `ScoringDaemon(engine="torch")` on
               the card: single-row submits from several threads plus
               4096-row `score_batch` frames.  Every answer is checked against
               `TorchScorer(device="cpu")`; the fused-block kernel must have
               launched num_layers x batches dispatched times.
5. serve    — the same artifact with fused_block="off": the small-attention
   unfused    kernel must launch and the fused-block kernel must not.
   profile  — both artifacts served once more under torch.profiler: the
               device's busy share of the wall time and its top kernels
               (Chrome traces written to chiprun_out/).
6. train    — the repo's headline MLP job at full width (bench.py: 30
               features, hidden (100, 100, 100) relu, bf16, weighted_mse,
               Adadelta 0.003, batch 65536, 2,621,440 rows; int8 wire) on
               synthetic rows, 2 epochs through `train(job, ..., device=cuda)`
               on the resident tier: samples/s and metrics per epoch; the
               int8 kernel must have launched once per train step and eval
               batch.
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
11. a JSON line {"kernels": [...]} with each kernel's launches on its path
   (serving for the FT kernels, training for int8_matmul), its error against
   the plain version, its times and its bound.
12. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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
SHIFU_ROWS = 20_000

SERVE_THREADS = 8
SERVE_ROWS_PER_THREAD = 512
SERVE_FRAMES = 2
SERVE_CLOSED_LOOP = 4 * 32   # 4 threads x 32 sequential score() calls


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


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


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    card's peak for the compute dtype (the tensor-core rate for bf16/f16,
    the CUDA-core rate for f32)."""
    import torch
    peak = (PEAK_16BIT_FLOPS if dtype in (torch.bfloat16, torch.float16)
            else PEAK_F32_FLOPS)
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_events(prof) -> list:
    """(name, device µs, count) of the device-side events of a profile:
    kernels, copies, memsets.  A CPU op's self device time repeats the
    time of the kernels it launched, so CPU ops are left out."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call, from the profiler: the summed durations of
    the kernels it launches, without the host time between them (CUDA
    events around a call that launches a short kernel time the wrapper's
    host work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(t for _, t, _ in device_events(prof))
    if total <= 0:
        fail("device_ms: the profiler saw no device time")
    return total / reps / 1e3


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


def ft_block_ops(b: int, s: int, d: int, h: int, r: int) -> float:
    """Operations of one block on these shapes: the four products, the
    attention products, and the elementwise work (LayerNorm ~8/elt, gelu
    ~10/elt, softmax ~4 per score, residual adds)."""
    m = b * s
    products = 2 * m * (3 * d * d + d * d + 2 * r * d * d)
    attention = 4 * b * h * s * s * (d // h)
    elementwise = 2 * 8 * m * d + 10 * m * r * d + 4 * b * h * s * s + 2 * m * d
    return float(products + attention + elementwise)


def check_ft_block(device, gen) -> dict:
    import torch
    from shifu_tpu_torch.config.schema import ModelSpec
    from shifu_tpu_torch.ops import ft_block

    def case(b, s, d, h, r):
        spec = ModelSpec(model_type="ft_transformer", token_dim=d,
                         num_attention_heads=h, mlp_ratio=r)
        p = block_params(d, r, gen, device)
        x = torch.randn(b, s, d, generator=gen).to(device)
        got = ft_block.fused_transformer_block(x, p, spec)
        want = ft_block.block_math(x, p, h)
        torch.cuda.synchronize()
        err = check_close(f"ft_block B={b} S={s} D={d} H={h} R={r}", got,
                          want, F32_ATOL, F32_RTOL)
        return spec, p, x, err

    edge_errs = [case(*shape)[3] for shape in
                 ((1, 31, 64, 8, 4), (7, 9, 16, 2, 2), (5, 13, 24, 3, 3),
                  (64, 64, 128, 16, 8), (3, 1, 8, 1, 1))]
    b, s, d, h, r = 4096, 31, 64, 8, 4
    spec, p, x, err = case(b, s, d, h, r)
    def kernel():
        return ft_block.fused_transformer_block(x, p, spec)

    def plain():
        return ft_block.block_math(x, p, h)

    ms, plain_ms = device_ms(kernel), device_ms(plain)
    call_ms, plain_call_ms = time_ms(kernel), time_ms(plain)
    n_bytes = 2 * x.numel() * 4 + sum(t.numel() for t in p.values()) * 4
    bnd, by = bound_ms(n_bytes, ft_block_ops(b, s, d, h, r), torch.float32)
    say(f"kernels: ft_block B={b} S={s} D={d} H={h} R={r} f32 max|err| "
        f"{err:.3e} (tol {F32_ATOL:g}+{F32_RTOL:g}*|ref|, f32 vs f32: "
        f"summation order only); edge shapes max|err| {max(edge_errs):.3e}; "
        f"device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}); whole call (CUDA events): kernel "
        f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms")
    return {"name": "ft_block", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/ft_block.cu",
            "replaces": "shifu_tpu/ops/pallas_ft_block.py:163",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def check_small_attention(device, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from shifu_tpu_torch.ops import small_attention as sa

    def case(b, h, s, d, dtype):
        q, k, v = (torch.randn(b, h, s, d, generator=gen).to(device, dtype)
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

    edge_errs = [case(*shape)[4] for shape in
                 ((1, 8, 31, 8, torch.bfloat16), (9, 4, 64, 16, torch.float32),
                  (33, 3, 9, 3, torch.float32), (5, 2, 64, 16, torch.bfloat16),
                  (17, 8, 31, 8, torch.float16), (2, 1, 1, 1, torch.float32))]
    b, h, s, d = 4096, 8, 31, 8
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
    bnd, by = bound_ms(n_bytes, n_ops, q.dtype)
    say(f"kernels: small_attention B={b} H={h} S={s} D={d} bf16 max|err| "
        f"{err:.3e} (tol {BF16_ATOL:g}+2^-7*|ref|: one bf16 ulp); edge shapes "
        f"max|err| {max(edge_errs):.3e}; device time: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max|diff| "
        f"{lib_err:.3e}), bound {bnd:.4f} ms ({by}); whole call (CUDA "
        f"events): kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms, "
        f"sdpa {library_call_ms:.4f} ms")
    return {"name": "small_attention", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/small_attention.cu",
            "replaces": "shifu_tpu/ops/pallas_small_attention.py:187",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}


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


def check_int8_matmul(device, gen) -> dict:
    import torch
    from shifu_tpu_torch.ops import int8_matmul as i8

    def case(m, f, n, dtype, with_offset, strided=False):
        q = torch.randint(-127, 128, (m, 2 * f if strided else f),
                          generator=gen, dtype=torch.int8)
        q = (q[:, ::2] if strided else q).to(device)
        w = (torch.randn(f, n, generator=gen) * f ** -0.5).to(device)
        b = (torch.randn(n, generator=gen) * 0.1).to(device)
        scale = torch.full((f,), 8.0 / 127, device=device)
        offset = ((torch.randn(f, generator=gen) * 0.1).to(device)
                  if with_offset else None)
        got = i8.int8_matmul_dequant(q, w, b, scale, offset, dtype)
        want = i8.int8_matmul_plain(q, w, b, scale, offset, dtype)
        torch.cuda.synchronize()
        label = (f"int8_matmul M={m} F={f} N={n} {dtype} offset="
                 f"{with_offset}{' strided q' if strided else ''}")
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

    edge_errs = [case(*shape)[5] for shape in
                 ((1, 30, 100, torch.bfloat16, False),
                  (1000, 30, 100, torch.bfloat16, True),
                  (777, 30, 100, torch.float32, True),
                  (513, 30, 100, torch.float16, False),
                  (300, 1, 7, torch.bfloat16, True),
                  (129, 4096, 4096, torch.bfloat16, False),
                  (65, 4096, 33, torch.float32, True),
                  (2000, 30, 100, torch.bfloat16, False, True))]
    m, f, n = 65536, 30, 100
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
        f"and after the bias add); edge shapes max|err| "
        f"{max(edge_errs):.3e}; device time: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}); whole call (CUDA "
        f"events): kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
        "library none (no single PyTorch call dequantizes int8 and "
        "multiplies)")
    return {"name": "int8_matmul", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "shifu_tpu/ops/pallas_int8_matmul.py:120",
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
    from shifu_tpu_torch.ops.ft_block import fused_transformer_block
    from shifu_tpu_torch.ops.small_attention import small_token_attention
    from shifu_tpu_torch.runtime.serve import ScoringDaemon

    rows = make_rows(threads * rows_per_thread, schema, rng)
    frames = [make_rows(frame_rows, schema, rng) for _ in range(n_frames)]
    daemon = ScoringDaemon(export_dir, config=ServingConfig(
        max_batch=max_batch), engine="torch", device=device)
    daemon.start()
    try:
        fused_transformer_block.launches = 0
        small_token_attention.launches = 0
        answers, frame_out, wall = drive_daemon(daemon, rows, frames,
                                                threads, closed_loop)
        launches = {"ft_block": fused_transformer_block.launches,
                    "small_attention": small_token_attention.launches}
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
    most device time, and writes a Chrome trace to `out_dir`.  The
    profiler slows the host, so this run's wall time is not a result."""
    import os
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
                                          f"serve_{label}_trace.json"))


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


def reset_launches() -> None:
    from shifu_tpu_torch.ops.ft_block import fused_transformer_block
    from shifu_tpu_torch.ops.int8_matmul import int8_matmul_dequant
    from shifu_tpu_torch.ops.small_attention import small_token_attention
    for fn in (fused_transformer_block, small_token_attention,
               int8_matmul_dequant):
        fn.launches = 0


def expected_int8_launches(job, n_train: int, n_valid: int,
                           epochs_run: int) -> tuple[int, int]:
    """(train steps, eval batches) of a run, from the job: each step and
    each eval batch sends one int8 batch into layer 0."""
    from shifu_tpu_torch.train.loop import eval_batch_size
    from shifu_tpu_torch.train.step import wire_fused_into_model
    if not wire_fused_into_model(job):
        fail("the headline job does not feed int8 into layer 0")
    steps = epochs_run * (n_train // job.data.batch_size)
    evaluated = sum(1 for e in range(epochs_run)
                    if e % job.train.eval_every_epochs == 0
                    or e == job.train.epochs - 1)
    per_eval = -(-n_valid // eval_batch_size(job, n_valid))
    return steps, evaluated * per_eval


def run_training(label: str, job, train_ds, valid_ds, device,
                 want_tier: str):
    """`train` on `device` with the launch counts set to 0 just before and
    read just after; checks the tier, the int8 launches and the metrics."""
    import math
    from shifu_tpu_torch.ops.ft_block import fused_transformer_block
    from shifu_tpu_torch.ops.int8_matmul import int8_matmul_dequant
    from shifu_tpu_torch.ops.small_attention import small_token_attention
    from shifu_tpu_torch.train.loop import train

    history = []
    reset_launches()
    res = train(job, train_ds, valid_ds,
                console=lambda ln: say(f"{label}: {ln}"),
                epoch_callback=history.append, device=device)
    launches = int8_matmul_dequant.launches
    if (fused_transformer_block.launches or small_token_attention.launches):
        fail(f"{label}: the MLP path launched an FT kernel")
    if res.tier != want_tier:
        fail(f"{label}: trained on the {res.tier!r} tier, expected "
             f"{want_tier!r}")
    steps, evals = expected_int8_launches(job, train_ds.num_rows,
                                          valid_ds.num_rows, len(history))
    if launches != steps + evals:
        fail(f"{label}: int8_matmul launched {launches} times, expected "
             f"{steps} train steps + {evals} eval batches")
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
    say(f"{label}: tier {res.tier}; int8_matmul launches {launches} = "
        f"{steps} train steps + {evals} eval batches")
    return res, launches


def lockstep(job, train_ds, device, n_steps: int = 8) -> None:
    """`n_steps` train steps from one init on the card and on the CPU, on
    the same batches; per-step losses within LOCKSTEP_RTOL."""
    import torch
    from shifu_tpu_torch.data import pipeline as pipe
    from shifu_tpu_torch.train.loop import init_state, to_device
    from shifu_tpu_torch.train.step import make_train_step

    wcast = pipe.wire_cast_fn(job.schema, job.data, job.model.compute_dtype,
                              compact=True)
    batches = []
    for b in pipe.batch_iterator(train_ds, job.data.batch_size,
                                 seed=job.data.shuffle_seed):
        batches.append(wcast(b))
        if len(batches) == n_steps:
            break
    def run(dev) -> tuple[np.ndarray, dict, dict]:
        state = init_state(job, job.schema.feature_count, dev)
        init = {k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()}
        step = make_train_step(job)
        out = []
        for b in batches:
            state, m = step(state, to_device(b, job, dev))
            out.append(float(m["loss"]))
        moved = {k: v.detach().cpu() - init[k]
                 for k, v in state.model.state_dict().items()}
        return np.asarray(out), init, moved

    (card, card_init, card_moved), (cpu, cpu_init, cpu_moved) = (
        run(device), run(torch.device("cpu")))
    rel = np.abs(card - cpu) / np.abs(cpu)
    if not np.all(np.isfinite(card)) or rel.max() > LOCKSTEP_RTOL:
        fail(f"lockstep: card losses {card.tolist()} vs CPU {cpu.tolist()}: "
             f"max rel diff {rel.max():.3e} > {LOCKSTEP_RTOL}")
    if any(not torch.equal(card_init[k], cpu_init[k]) for k in cpu_init):
        fail("lockstep: the card and the CPU started from other weights")
    # the losses barely move in 8 steps (Adadelta at 0.003 changes a weight
    # by ~1e-6 a step), so the backward and the update are held here: each
    # parameter's change, card against CPU, relative to the CPU's change
    moved_rel = {}
    for k, d_cpu in cpu_moved.items():
        norm = float(d_cpu.norm())
        if norm == 0.0:
            fail(f"lockstep: {k} did not move on the CPU in {n_steps} steps")
        moved_rel[k] = float((card_moved[k] - d_cpu).norm()) / norm
    worst = max(moved_rel, key=moved_rel.get)
    if not moved_rel[worst] <= LOCKSTEP_MOVED_RTOL:
        fail(f"lockstep: parameter changes, card vs CPU: |d_card - d_cpu| / "
             f"|d_cpu| {moved_rel[worst]:.3e} on {worst} > "
             f"{LOCKSTEP_MOVED_RTOL:g}; per leaf {moved_rel}")
    say(f"lockstep: {n_steps} steps at batch {job.data.batch_size}, card vs "
        f"CPU from one init: max rel loss diff {rel.max():.3e} (tol "
        f"{LOCKSTEP_RTOL:g}, bf16); card losses "
        f"{[round(v, 6) for v in card.tolist()]}; parameter change "
        f"|d_card - d_cpu| / |d_cpu| worst {moved_rel[worst]:.3e} on "
        f"{worst} (tol {LOCKSTEP_MOVED_RTOL:g}), per leaf "
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
                               want_tier="batch")
    reset_launches()
    from shifu_tpu_torch.ops.int8_matmul import int8_matmul_dequant
    from shifu_tpu_torch.train.loop import train
    res = train(job, console=lambda ln: None, device=device)
    if int8_matmul_dequant.launches != launches or res.tier != "batch":
        fail(f"shifu: train(job) from the files launched "
             f"{int8_matmul_dequant.launches} times on the {res.tier!r} "
             f"tier, the loaded datasets {launches} times on 'batch'")
    say(f"shifu: job_config_from_shifu({SHIFU_ROWS} rows in 4 gzip parts) "
        f"-> {job.model.model_type} {job.model.hidden_nodes}, batch "
        f"{job.data.batch_size}, {job.train.optimizer.name}; train(job) "
        f"from the files on the per-batch tier launched the int8 kernel "
        f"{launches} times")


def profile_training(job, train_ds, valid_ds, device,
                     out_dir: str = "chiprun_out") -> None:
    """A steady-state training epoch under torch.profiler: the window runs
    from the end of epoch 0 to the end of epoch 1 (its 40 steps and its
    eval); prints the device's busy share of the window and its top
    kernels and writes a Chrome trace to `out_dir`.  The profiler slows
    the host, so the window's wall time is not a result."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from shifu_tpu_torch.train.loop import train

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
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
        fail("profile train: the profiler saw no device time")
    wall = window["wall"]
    say(f"profile train: epoch 1 (40 steps + eval), wall {wall * 1e3:.3f} "
        f"ms under the profiler, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e6 / wall:.2f}% of wall)")
    for key, t, n in sorted(avgs, key=lambda a: -a[1])[:10]:
        say(f"profile train:   {t / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_trace.json"))


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
                                 want_tier="resident")
    next(k for k in kernels if k["name"] == "int8_matmul")["launches"] = \
        launches

    lockstep(job, train_ds, device)
    shifu_files_run(tmp, device)

    export_dir = save_artifact(res.state.model, job.model, job.schema,
                               f"{tmp}/trained_mlp")
    served = serve_phase("trained", export_dir, job.schema,
                         np.random.default_rng(SEED), device)
    report_serve("trained", served)
    profile_training(job, train_ds, valid_ds, device)


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
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    say(smi_line)
    device = torch.device("cuda:0")

    # phase 2: build
    build_s = _build.build_all()
    for src in sorted(_build.build_logs):
        usage = [ln.strip() for ln in _build.build_logs[src].splitlines()
                 if "registers" in ln or "spill" in ln]
        say(f"build: {src}: " + " | ".join(usage))
    say(f"build: {len(_build.sources())} kernels in {build_s:.2f} s")

    # phase 3: kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    kernels = [check_ft_block(device, gen), check_small_attention(device, gen),
               check_int8_matmul(device, gen)]

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
        want = spec.num_layers * res["dispatched"]
        if res["launches"]["ft_block"] != want:
            fail(f"fused path: ft_block launched "
                 f"{res['launches']['ft_block']} times, expected "
                 f"num_layers x batches = {want}")
        if res["launches"]["small_attention"] != 0:
            fail("fused path launched the small-attention kernel")
        kernels[0]["launches"] = res["launches"]["ft_block"]

        off_spec = dataclasses.replace(spec, fused_block="off")
        off_dir = save_artifact(model, off_spec, schema, f"{tmp}/unfused")
        res = serve_phase("unfused", off_dir, schema, rng, device)
        report_serve("unfused", res)
        if res["launches"]["small_attention"] != (
                spec.num_layers * res["dispatched"]):
            fail(f"unfused path: small_attention launched "
                 f"{res['launches']['small_attention']} times, expected "
                 f"{spec.num_layers * res['dispatched']}")
        if res["launches"]["ft_block"] != 0:
            fail("unfused path launched the fused-block kernel")
        kernels[1]["launches"] = res["launches"]["small_attention"]

        profile_serve("fused", fused_dir, schema, rng, device)
        profile_serve("unfused", off_dir, schema, rng, device)

        # phases 6 to 10: train the headline MLP on the int8 wire
        training_phases(device, tmp, kernels)

    # phase 11: the kernels line; phase 12: the result line
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
