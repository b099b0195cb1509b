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
               the serving path's shapes and at edge shapes, with the
               tolerance stated beside each check; median times (CUDA events)
               of kernel, plain version and, for attention,
               `scaled_dot_product_attention` as a yardstick; the least time
               the card could take (bound).
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
6. a JSON line {"kernels": [...]} with each kernel's launches on the serving
   path, its error against the plain version, its times and its bound.
7. the last line: {"ok": true, "device": {...}}.

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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ms = time_ms(lambda: ft_block.fused_transformer_block(x, p, spec))
    plain_ms = time_ms(lambda: ft_block.block_math(x, p, h))
    n_bytes = 2 * x.numel() * 4 + sum(t.numel() for t in p.values()) * 4
    bnd, by = bound_ms(n_bytes, ft_block_ops(b, s, d, h, r))
    say(f"kernels: ft_block B={b} S={s} D={d} H={h} R={r} f32 max|err| "
        f"{err:.3e} (tol {F32_ATOL:g}+{F32_RTOL:g}*|ref|, f32 vs f32: "
        f"summation order only); edge shapes max|err| {max(edge_errs):.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
        f"({by})")
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
    ms = time_ms(lambda: sa.small_token_attention(q, k, v))
    plain_ms = time_ms(lambda: sa.small_attention_plain(q, k, v, scale))
    lib_out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    lib_err = (lib_out.float() - sa.small_attention_plain(
        q, k, v, scale).float()).abs().max().item()
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    n_bytes = 4 * q.numel() * q.element_size()
    n_ops = 4.0 * b * h * s * s * d + 4.0 * b * h * s * s
    bnd, by = bound_ms(n_bytes, n_ops)
    say(f"kernels: small_attention B={b} H={h} S={s} D={d} bf16 max|err| "
        f"{err:.3e} (tol {BF16_ATOL:g}+2^-7*|ref|: one bf16 ulp); edge shapes "
        f"max|err| {max(edge_errs):.3e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max|diff| "
        f"{lib_err:.3e}), bound {bnd:.4f} ms ({by})")
    return {"name": "small_attention", "route": "cuda",
            "source": "shifu_tpu_torch/csrc/small_attention.cu",
            "replaces": "shifu_tpu/ops/pallas_small_attention.py:187",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": library_ms}


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
    avgs = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
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
    kernels = [check_ft_block(device, gen), check_small_attention(device, gen)]

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

    # phase 6: the kernels line; phase 7: the result line
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
