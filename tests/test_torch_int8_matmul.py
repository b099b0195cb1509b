"""The port's fused int8-dequant first layer (shifu_tpu_torch/ops/
int8_matmul.py) against the JAX package's kernel #4
(shifu_tpu/ops/pallas_int8_matmul.py): the Pallas kernel in interpret mode
on the CPU and its XLA reference.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that version on the card by
chip_smoke.py.

Tolerances: the kernel and the reference sum the F products in other
orders (f32 error up to F * 2^-24 * (|x|@|w|)), and the rounding of the sum
to the compute dtype and the rounding after the bias add may each then
flip by one ulp, so a bound relative to |ref| fails spuriously near 0.
bf16 allows 2^-7 * (2|x@w| + |b|) + F * 2^-24 * (|x|@|w|) + 1e-6, f16 the
same with 2^-10, f32 1e-5 + 1e-5 * |ref| (tests/test_roofline.py's f32
bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.ops import pallas_int8_matmul as jax_i8
from shifu_tpu_torch.ops import int8_matmul as i8

_DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32),
           "float16": (torch.float16, jnp.float16)}


def _operands(m, f, n, seed, offset):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (m, f)).astype(np.int8)
    w = (rng.standard_normal((f, n)) / np.sqrt(f)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    scale = np.full((f,), 8.0 / 127, np.float32)
    off = (rng.standard_normal((f,)).astype(np.float32) * 0.1
           if offset else None)
    return q, w, b, scale, off


def _tol(q, w, b, scale, off, cdt_name, ref):
    """Elementwise allowed |port - JAX| (module docstring)."""
    if cdt_name == "float32":
        return 1e-5 + 1e-5 * np.abs(ref)
    td = _DTYPES[cdt_name][0]
    x = i8.dequant_plain(torch.from_numpy(q), torch.from_numpy(scale),
                         None if off is None else torch.from_numpy(off))
    xc = x.to(td).float()
    wc = torch.from_numpy(w).to(td).float()
    bc = torch.from_numpy(b).to(td).float()
    ulp = 2.0 ** -7 if cdt_name == "bfloat16" else 2.0 ** -10
    f = q.shape[1]
    return (ulp * (2 * (xc @ wc).abs() + bc.abs())
            + f * 2.0 ** -24 * (xc.abs() @ wc.abs())).numpy() + 1e-6


def _port(q, w, b, scale, off, cdt_name):
    return i8.int8_matmul_dequant(
        torch.from_numpy(q), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(scale),
        None if off is None else torch.from_numpy(off),
        _DTYPES[cdt_name][0])


def _jax(q, w, b, scale, off, cdt_name, use_pallas):
    return jax_i8.int8_matmul_dequant(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(b), jnp.asarray(scale),
        None if off is None else jnp.asarray(off),
        compute_dtype=_DTYPES[cdt_name][1], use_pallas=use_pallas)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", [(37, 30, 16), (1, 30, 100),
                                   (300, 30, 100), (9, 1, 7),
                                   (5, 257, 65)])
def test_plain_matches_pallas_interpret_and_xla_reference(cdt, offset,
                                                          shape):
    m, f, n = shape
    ops = _operands(m, f, n, seed=m * 7 + f + n, offset=offset)
    got = _port(*ops, cdt)
    assert got.dtype == _DTYPES[cdt][0] and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    for use_pallas in (True, False):
        want = np.asarray(_jax(*ops, cdt, use_pallas).astype(jnp.float32))
        tol = _tol(*ops, cdt, want)
        assert np.all(np.abs(got - want) <= tol), (
            f"use_pallas={use_pallas}: max |err| "
            f"{np.abs(got - want).max():.3e}")


def test_widest_shape_matches_xla_reference():
    """F = N = 4096, the gate's upper edge, in bf16."""
    ops = _operands(3, 4096, 4096, seed=5, offset=False)
    got = _port(*ops, "bfloat16").float().numpy()
    want = np.asarray(_jax(*ops, "bfloat16", False).astype(jnp.float32))
    assert np.all(np.abs(got - want) <= _tol(*ops, "bfloat16", want))


def test_non_contiguous_q_equals_contiguous():
    q, w, b, scale, off = _operands(40, 30, 16, seed=3, offset=True)
    wide = np.zeros((40, 60), np.int8)
    wide[:, ::2] = q
    strided = torch.from_numpy(wide)[:, ::2]
    assert not strided.is_contiguous()
    args = [torch.from_numpy(t) for t in (w, b, scale, off)]
    got = i8.int8_matmul_dequant(strided, *args[:3], args[3],
                                 torch.bfloat16)
    want = i8.int8_matmul_dequant(torch.from_numpy(q), *args[:3], args[3],
                                  torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_grads_match_jax_custom_vjp(cdt):
    """dW and db against the JAX kernel's custom VJP (interpret mode) and
    its XLA path, through a linear loss sum(y * c) so that dy = c on both
    sides whatever the forward's last-ulp rounding.  f32: rtol 1e-5 /
    atol 1e-4 (tests/test_roofline.py).  bf16: dW against the custom VJP
    differs by summation order only (rtol 1e-5); the XLA path rounds dW to
    bf16 (the autograd of the cast): one bf16 ulp (2^-7).  db is a sum of
    bf16 cotangents: the port accumulates in f32 and rounds once (exact to
    one bf16 ulp), while XLA on the CPU rounds as it accumulates, so the
    JAX side may drift by up to 2^-7 * sum|c| over the 37 rows."""
    q, w, b, scale, off = _operands(37, 30, 16, seed=11, offset=True)
    tdt, jdt = _DTYPES[cdt]
    rng = np.random.default_rng(12)
    c = torch.from_numpy(rng.standard_normal((37, 16)).astype(np.float32)
                         ).to(tdt).float()
    qj, sj, oj = jnp.asarray(q), jnp.asarray(scale), jnp.asarray(off)
    cj = jnp.asarray(c.numpy())

    def jax_loss(use_pallas, w_, b_):
        y = jax_i8.int8_matmul_dequant(qj, w_, b_, sj, oj, compute_dtype=jdt,
                                       use_pallas=use_pallas)
        return jnp.sum(y.astype(jnp.float32) * cj)

    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = i8.int8_matmul_dequant(torch.from_numpy(q), wt, bt,
                               torch.from_numpy(scale),
                               torch.from_numpy(off), tdt)
    (y.float() * c).sum().backward()
    for use_pallas in (True, False):
        gw, gb = jax.grad(lambda w_, b_: jax_loss(use_pallas, w_, b_),
                          argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
        bf16 = cdt == "bfloat16"
        rtol_w = 2.0 ** -7 if bf16 and not use_pallas else 1e-5
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw),
                                   rtol=rtol_w, atol=1e-4)
        if bf16:
            exact = c.sum(dim=0).to(torch.bfloat16).float().numpy()
            np.testing.assert_allclose(bt.grad.numpy(), exact,
                                       rtol=2.0 ** -7, atol=1e-4)
            bound = 2.0 ** -7 * c.abs().sum(dim=0).numpy()
            assert np.all(np.abs(bt.grad.numpy() - np.asarray(gb)) <= bound)
        else:
            np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb),
                                       rtol=1e-5, atol=1e-4)


def test_no_grad_for_q_scale_offset():
    q, w, b, scale, off = _operands(8, 30, 4, seed=2, offset=True)
    s = torch.from_numpy(scale).requires_grad_(True)
    o = torch.from_numpy(off).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = i8.int8_matmul_dequant(torch.from_numpy(q), wt,
                               torch.from_numpy(b), s, o, torch.float32)
    y.sum().backward()
    assert s.grad is None and o.grad is None and wt.grad is not None


@pytest.mark.parametrize("f,n", [(0, 1), (1, 0), (1, 1), (30, 100),
                                 (4096, 4096), (4097, 1), (1, 4097)])
def test_shape_gate_matches_jax(f, n, monkeypatch):
    monkeypatch.delenv(jax_i8.ENV_DISABLE, raising=False)
    assert i8.int8_available(f, n) == jax_i8.fused_available(f, n)


class _FakeCudaTensor:
    """Stands in for a CUDA tensor where there is no card: only its device
    is read before the route is chosen."""
    device = torch.device("cuda", 0)


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    calls = []

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(i8, "int8_matmul_plain", no_plain)
    monkeypatch.setattr(i8, "_launch", lambda *a: calls.append(a) or "out")
    q = _FakeCudaTensor()
    assert i8._forward(q, None, None, None, None, torch.bfloat16) == "out"
    assert calls and calls[0][0] is q


def test_cuda_launch_failure_raises(monkeypatch):
    """A kernel that cannot take a CUDA call raises; nothing falls back."""
    monkeypatch.setattr(i8, "int8_matmul_plain", lambda *a, **k: (
        pytest.fail("fell back to the plain version")))

    def refuse(*a):
        raise RuntimeError("int8_matmul kernel launch failed")

    monkeypatch.setattr(i8, "_launch", refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        i8._forward(_FakeCudaTensor(), None, None, None, None, torch.float32)


def test_other_devices_raise():
    q = torch.zeros((2, 3), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        i8._forward(q, None, None, None, None, torch.float32)


def test_cpu_runs_plain_and_counts_no_launch():
    before = i8.int8_matmul_dequant.launches
    ops = _operands(4, 30, 8, seed=1, offset=False)
    _port(*ops, "bfloat16")
    assert i8.int8_matmul_dequant.launches == before


def test_wire_dense_routes_within_the_gate(monkeypatch):
    """Layer 0 sends an int8 batch to the wrapper; a layer outside the
    shape gate is refused when it is built (the trainer decodes the wire
    before the model there)."""
    from shifu_tpu_torch.models import base

    seen = []
    real = i8.int8_matmul_dequant
    monkeypatch.setattr(base, "int8_matmul_dequant",
                        lambda *a: seen.append("kernel") or real(*a))
    f = 30
    grid = ((8.0 / 127,) * f, None)
    layer = base._WireDense(f, 4, grid, "float32",
                            generator=torch.Generator().manual_seed(0))
    q = torch.randint(-127, 128, (3, f), dtype=torch.int8)
    y = layer(q)
    assert seen == ["kernel"] and y.dtype == torch.float32
    x = (q.float() * (8.0 / 127))
    torch.testing.assert_close(y, layer(x), rtol=1e-5, atol=1e-5)
    for f_in, n_out in ((4097, 4), (30, 4097)):
        with pytest.raises(ValueError, match="shape gate"):
            base._WireDense(f_in, n_out, ((1.0,) * f_in, None))
    assert set(base._WireDense(2, 2, ((1.0, 1.0), None)).state_dict()) == {
        "kernel", "bias"}
