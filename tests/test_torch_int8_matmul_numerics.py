"""The rounding argument of the tensor-core int8 first layer (kernel #4,
shifu_tpu_torch/csrc/int8_matmul.cu), modelled in PyTorch on the CPU.

The kernel dequantizes q in f32 (q * scale, then + offset), rounds x and w
to the compute dtype, and runs the product on the tensor cores: mma.sync
m16n8k16, 16 features a k-step.  A product of two bf16 or f16 values is
exact in f32; the tensor cores add a k-step's 16 products into the f32
accumulator, the sum truncated toward zero.  For compute dtype f32, x and w
enter as bf16 hi = rounded and lo = the rest rounded, and each k-step takes
three passes, hi hi, hi lo, lo hi (lo lo dropped), each added to the
accumulator.  Past 64 features (the tiled kernel) each chunk of 64 sums
into an accumulator of its own, added to the running sum with an f32 add
rounded to nearest.  The sum is rounded to the compute dtype, and the bias,
rounded too, is added in f32 and rounded once more.

The model below does the same roundings (a k-step's 16 products summed
exactly, then one truncation: the hardware may keep fewer bits inside the
step, which the tolerance's summation term covers) and is held to
chip_smoke.py's tolerances against `int8_matmul_plain`, which the card
holds the kernel to: `int8_tolerance` in bf16 and f16, F32_ATOL /
F32_RTOL in f32, at `chip_smoke.INT8_EDGE_SHAPES` (rows cut to at most 64,
columns to at most 300) and at the path's shape (rows cut to 4096).  As a
contrast, f32 in one pass (hi hi alone) misses the f32 tolerance at the
path's shape, and at F = 4096 the f32 sum without its chunks, truncated
over 256 k-steps x 3 passes, drifts past it as the card's did: three
passes and the fold are the cheapest that meet it.

These tests check the rounding argument, not the kernel: nothing ties the
model to the CUDA code, and only chip_smoke.py's check_int8_matmul holds
the kernel itself.  The model is not on any path: nothing in the package
calls it.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from shifu_tpu_torch.ops import int8_matmul as i8

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

K_STEP = 16     # mma.sync m16n8k16
PANEL_K = 64    # the panel kernel takes F <= 64 in one chunk
PANEL_N = 128   # and N <= 128
CHUNK = 64      # the tiled kernel's chunk of features
MAX_M, MAX_N = 64, 300


def _truncate(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """f32(acc + part) rounded toward zero; acc f32, part f64 (exact)."""
    s = acc.double() + part
    r = s.float()
    away = r.double().abs() > s.abs()
    return torch.where(away, torch.nextafter(r, torch.zeros_like(r)), r)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 hi and lo of an f32 tensor, as f64 values."""
    hi = x.to(torch.bfloat16).float()
    return hi.double(), (x - hi).to(torch.bfloat16).double()


def model(q, w, b, scale, offset, dtype, passes: int = 3,
          fold: bool = True) -> torch.Tensor:
    """The kernel's output as the model computes it (module docstring)."""
    m, f = q.shape
    x = i8.dequant_plain(q, scale, offset)
    if dtype == torch.float32:
        (xh, xl), (wh, wl) = _split(x), _split(w.float())
        terms = [(xh, wh), (xh, wl), (xl, wh)][:passes]
    else:
        terms = [(x.to(dtype).double(), w.to(dtype).double())]
    panel = f <= PANEL_K and w.shape[1] <= PANEL_N
    chunk = f if (panel or not fold) else CHUNK
    total = torch.zeros((m, w.shape[1]), dtype=torch.float32)
    for c0 in range(0, f, chunk):
        acc = torch.zeros_like(total)
        for k0 in range(c0, min(f, c0 + chunk), K_STEP):
            ks = slice(k0, min(f, k0 + K_STEP))
            for a, bw in terms:
                acc = _truncate(acc, a[:, ks] @ bw[ks])
        total = (total.double() + acc.double()).float()
    y = total.to(dtype).float() + b.to(dtype).float()
    return y.to(dtype)


def _operands(m, f, n, with_offset, seed):
    """chip_smoke.check_int8_matmul's operands, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (m, f)).astype(np.int8))
    w = torch.from_numpy((rng.standard_normal((f, n)) * f ** -0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    scale = torch.full((f,), 8.0 / 127)
    offset = (torch.from_numpy((rng.standard_normal(f) * 0.1)
                               .astype(np.float32)) if with_offset else None)
    return q, w, b, scale, offset


def _misses(got, q, w, b, scale, offset, dtype) -> float:
    """The largest excess of |got - plain| over chip_smoke's tolerance
    (<= 0 when it holds)."""
    want = i8.int8_matmul_plain(q, w, b, scale, offset, dtype).float()
    diff = (got.float() - want).abs()
    assert torch.isfinite(got.float()).all()
    tol = smoke.int8_tolerance(
        i8.dequant_plain(q, scale, offset).to(dtype).float(),
        w.to(dtype).float(), b.to(dtype).float(), dtype)
    if tol is None:
        tol = smoke.F32_ATOL + smoke.F32_RTOL * want.abs()
    return float((diff - tol).max())


@pytest.mark.parametrize("shape", smoke.INT8_EDGE_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_model_holds_at_the_edge_shapes(shape):
    m, f, n, dt, with_offset, _ = shape
    dtype = getattr(torch, dt)
    ops = _operands(min(m, MAX_M), f, min(n, MAX_N), with_offset, seed=m + n)
    assert _misses(model(*ops, dtype), *ops, dtype) <= 0


@pytest.mark.parametrize("dt", ["bfloat16", "float16", "float32"])
def test_model_holds_at_the_path_shape(dt):
    m, f, n = smoke.INT8_SHAPE
    dtype = getattr(torch, dt)
    ops = _operands(4096, f, n, False, seed=1)
    assert _misses(model(*ops, dtype), *ops, dtype) <= 0


def test_one_pass_misses_f32():
    """f32 rounded once to bf16 (hi hi alone) misses F32_ATOL/F32_RTOL."""
    m, f, n = smoke.INT8_SHAPE
    ops = _operands(4096, f, n, True, seed=2)
    assert _misses(model(*ops, torch.float32, passes=1), *ops,
                   torch.float32) > 0


def test_f32_needs_the_chunk_fold_at_4096_features():
    """At F = 4096 the f32 sum truncated over all 256 k-steps in one
    accumulator drifts past the tolerance (the card read 2.4e-4 at
    (65, 4096, 33) before the fold); summed a chunk at a time it holds."""
    ops = _operands(65, 4096, 33, True, seed=65 + 33)
    assert _misses(model(*ops, torch.float32, fold=False), *ops,
                   torch.float32) > 0
    assert _misses(model(*ops, torch.float32), *ops, torch.float32) <= 0
