"""The rounding argument of the tensor-core flash kernels (kernels #7 and
#8, shifu_tpu_torch/csrc/flash_*.cu), modelled in PyTorch on the CPU.

The kernels feed the tensor cores 16-bit operands and sum in f32.  Q K^T
and dO V^T take the inputs as they are; P and dS, computed in f32, go in
as two 16-bit parts (hi = x rounded, lo = x - hi rounded; in f16 dS's lo
part is scaled by 2^11 into an accumulator of its own); f32 inputs go in
as bf16 hi + lo parts, three products each (hi hi, hi lo, lo hi).  The
forward keeps the running max and sum over key tiles of the forward
kernel's size at each padded head dim (`_key_tile`).  The model below does
the same roundings, and is held to chip_smoke.py's flash tolerances against
the plain versions (`flash_fwd_plain`, `flash_bwd_*_plain`), which the card
holds the kernels to.  At S = 1001 in bf16 the contrast, P and dS rounded
once to bf16, misses those tolerances: the check tells the two designs
apart.

These tests check the rounding argument, not the kernels: nothing ties the
model to the CUDA code, and only chip_smoke.py's check_flash holds the
kernels themselves.  The model is not on any path: nothing in the package
calls it.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from shifu_tpu_torch.ops import flash_attention as fa

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LOG2E = 1.0 / math.log(2.0)
F16_LO_SCALE = 2.0 ** 11


def _key_tile(d: int) -> int:
    """The forward kernel's streamed keys a tile at head dim d (Tile::kN in
    csrc/flash_common.cuh, d padded to 8, 16, 32, 64 or 128)."""
    return 64 if d <= 8 else 32 if d <= 16 else 64 if d <= 64 else 32


# check_flash's edge shapes (B, H, S, D, dtype) with B and H capped at 2,
# and the path's (S, D) at B * H = 2
SHAPES = [(min(b, 2), min(h, 2), s, d, getattr(torch, dt))
          for b, h, s, d, dt in smoke.FLASH_EDGE_SHAPES]
SHAPES.append((1, 2, 1001, 8, torch.bfloat16))


def _mma_type(dtype):
    return torch.float16 if dtype == torch.float16 else torch.bfloat16


def _parts(x, e, lo_scale=1.0):
    """hi and lo of an f32 tensor in the 16-bit type e, as f32 values."""
    hi = x.to(e).float()
    lo = ((x - hi) * lo_scale).to(e).float() / lo_scale
    return hi, lo


def _operand(x):
    """An input as the tensor cores see it: itself, or bf16 hi + lo."""
    if x.dtype == torch.float32:
        return _parts(x, torch.bfloat16)
    return x.float(), None


def _computed(x, e, split, lo_scale=1.0):
    """P or dS (f32) as the tensor cores see it."""
    if split:
        return _parts(x, e, lo_scale)
    return x.to(e).float(), None


def _t(op):
    return tuple(None if p is None else p.transpose(-1, -2) for p in op)


def _prod(a, b):
    """a @ b on (hi, lo) operands: hi hi + hi lo + lo hi, f32 sums."""
    out = a[0] @ b[0]
    if b[1] is not None:
        out = out + a[0] @ b[1]
    if a[1] is not None:
        out = out + a[1] @ b[0]
    return out


def model_fwd(q, k, v, scale, split=True):
    e = _mma_type(q.dtype)
    c = abs(scale) * LOG2E
    qo, ko, vo = _operand(q), _operand(k), _operand(v)
    s_all = _prod(qo, _t(ko))
    n, s_len = s_all.shape[:-1], q.shape[-2]
    m = torch.full(n, -math.inf)
    l = torch.zeros(n)
    acc = torch.zeros(*n, q.shape[-1])
    tile = _key_tile(q.shape[-1])
    for k0 in range(0, s_len, tile):
        s = s_all[..., k0:k0 + tile]
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - (mx * c).unsqueeze(-1))
        l = l * corr + p.sum(-1)
        vt = tuple(None if t is None else t[..., k0:k0 + tile, :]
                   for t in vo)
        acc = acc * corr.unsqueeze(-1) + _prod(_computed(p, e, split), vt)
        m = mx
    out = (acc / l.unsqueeze(-1)).to(q.dtype)
    return out, m * abs(scale) + torch.log(l)


def model_bwd(q, k, v, g, lse, dres, scale, split=True):
    e = _mma_type(q.dtype)
    c = abs(scale) * LOG2E
    qo, ko, vo, go = (_operand(t) for t in (q, k, v, g))
    s = _prod(qo, _t(ko))
    p = torch.exp2(s * c - (lse * LOG2E).unsqueeze(-1))
    ds = p * (_prod(go, _t(vo)) - dres.unsqueeze(-1))
    lo_scale = F16_LO_SCALE if q.dtype == torch.float16 else 1.0
    dsp = _computed(ds, e, split, lo_scale)
    dq = _prod(dsp, ko) * scale
    dk = _prod(_t(dsp), qo) * scale
    dv = _prod(_t(_computed(p, e, split)), go)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _ok(got, want, atol, rtol) -> bool:
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= atol + rtol * want.abs()).all())


def _out_ok(out, want):
    if want.dtype == torch.float32:
        return _ok(out, want, smoke.F32_ATOL, smoke.F32_RTOL)
    ulp = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2.0 ** -10
    return _ok(out, want, 1e-6, ulp)


def _grad_ok(got, want):
    """chip_smoke.check_grad's tolerance."""
    frac, rtol, _ = smoke.grad_tolerance(want.dtype)
    atol = (smoke.F32_ATOL if want.dtype == torch.float32
            else frac * float(want.float().abs().max()) + 1e-12)
    return _ok(got, want, atol, rtol)


def _case(b, h, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, s, d))
                                   .astype(np.float32)).to(dtype)
                  for _ in range(4))
    scale = d ** -0.5
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, scale)
    dres = fa.flash_dres(out_p, g)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, g, lse_p, dres, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, g, lse_p, dres, scale)
    return (q, k, v, g, scale, lse_p, dres), (out_p, lse_p, dq_p, dk_p, dv_p)


def _verdicts(inputs, want, split):
    q, k, v, g, scale, lse_p, dres = inputs
    out_p, _, dq_p, dk_p, dv_p = want
    out, lse = model_fwd(q, k, v, scale, split)
    dq, dk, dv = model_bwd(q, k, v, g, lse_p, dres, scale, split)
    return {"out": _out_ok(out, out_p),
            "lse": _ok(lse, lse_p, smoke.F32_ATOL, smoke.F32_RTOL),
            "dq": _grad_ok(dq, dq_p), "dk": _grad_ok(dk, dk_p),
            "dv": _grad_ok(dv, dv_p)}


@pytest.mark.parametrize("b,h,s,d,dtype", SHAPES)
def test_split_operands_meet_the_chip_tolerances(b, h, s, d, dtype):
    inputs, want = _case(b, h, s, d, dtype, seed=1000 * s + d)
    verdicts = _verdicts(inputs, want, split=True)
    assert all(verdicts.values()), verdicts


def test_rounding_p_and_ds_once_misses_them_at_the_path_shape():
    inputs, want = _case(1, 2, 1001, 8, torch.bfloat16, seed=1001)
    verdicts = _verdicts(inputs, want, split=False)
    assert not verdicts["out"] and not verdicts["dq"], verdicts
    assert not (verdicts["dk"] and verdicts["dv"]), verdicts
    assert verdicts["lse"]  # lse does not pass through P V
