"""The port's fused FT block (shifu_tpu_torch/ops/ft_block.py) against the
JAX package's Pallas kernel (shifu_tpu/ops/pallas_ft_block.py) run in
interpret mode on the CPU, forward and custom-VJP gradients, and the two
packages' engagement gates.

On the CPU the port's wrapper runs the kernel's plain PyTorch twin; the CUDA
kernel itself is held against that twin on the card by chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shifu_tpu.config.schema import ModelSpec as JaxModelSpec
from shifu_tpu.ops import pallas_ft_block as jax_ftb
from shifu_tpu_torch.config.schema import ModelSpec
from shifu_tpu_torch.ops import _build
from shifu_tpu_torch.ops import ft_block

# f32 against f32: only the summation order differs (the bound
# tests/test_roofline.py holds the fused kernel to)
TOL = 2e-5


def _params(rng, d, r):
    shapes = ft_block._param_shapes(d, r)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("_kernel"):
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = rng.uniform(-lim, lim, size=shape)
        elif name.endswith("_scale"):
            out[name] = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            out[name] = 0.1 * rng.normal(size=shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _specs(d, h, r, fused_block="on"):
    kw = dict(model_type="ft_transformer", token_dim=d,
              num_attention_heads=h, mlp_ratio=r, fused_block=fused_block)
    return JaxModelSpec(**kw), ModelSpec(**kw)


@pytest.mark.parametrize("s", [9, 16])
def test_plain_block_matches_pallas_interpret(s):
    b, d, h, r = 4, 16, 2, 2
    rng = np.random.default_rng(100 + s)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    p = _params(rng, d, r)
    jspec, tspec = _specs(d, h, r)
    want = np.asarray(jax_ftb.fused_transformer_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jspec))
    got = ft_block.fused_transformer_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        tspec)
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert ft_block.fused_transformer_block.launches == 0  # CPU: no kernel


def test_wrapper_returns_input_dtype():
    b, s, d, h, r = 2, 5, 8, 2, 1
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, r).items()}
    spec = _specs(d, h, r)[1]
    out = ft_block.fused_transformer_block(x.to(torch.bfloat16), p, spec)
    assert out.dtype == torch.bfloat16
    ref = ft_block.block_math(x.to(torch.bfloat16).float(), p, h)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("s", [1, 8, 31, 64, 65])
@pytest.mark.parametrize("d,h", [(8, 1), (12, 3), (64, 8), (128, 16),
                                 (130, 2), (10, 4)])
@pytest.mark.parametrize("r", [1, 4, 8, 9])
def test_applicability_gate_matches_jax(s, d, h, r):
    assert (ft_block.ft_block_applicable(s, d, h, r)
            == jax_ftb.ft_block_applicable(s, d, h, r))


def test_engagement_gate_matches_jax():
    """Same rules as the JAX gate at inference for on/off and the shape
    limits; "auto" engages wherever the shape fits (JAX engages it on a TPU
    only)."""
    jspec, tspec = _specs(64, 8, 4)
    for kw in (dict(), dict(fused_block="off"), dict(dropout_rate=0.1),
               dict(attention_impl="flash")):
        for s in (31, 65):
            j = jax_ftb.fused_block_engaged(
                dataclasses.replace(jspec, **kw), s)
            t = ft_block.fused_block_engaged(
                dataclasses.replace(tspec, **kw), s)
            assert j == t, (kw, s)
    auto = dataclasses.replace(tspec, fused_block="auto")
    assert ft_block.fused_block_engaged(auto, 31)
    assert not ft_block.fused_block_engaged(auto, 65)


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("train", [False, True])
def test_engagement_gate_train_rule_matches_jax(mode, dropout, train):
    """The training rule of the JAX gate: a block with dropout is not fused
    in training.  "auto" is held to JAX's "on", since JAX engages "auto"
    only on a TPU (ROADMAP.md section C)."""
    jspec, tspec = _specs(64, 8, 4, fused_block=mode)
    jspec = dataclasses.replace(jspec, dropout_rate=dropout,
                                fused_block="on" if mode == "auto" else mode)
    tspec = dataclasses.replace(tspec, dropout_rate=dropout)
    for s in (31, 65):
        assert (ft_block.fused_block_engaged(tspec, s, train=train)
                == jax_ftb.fused_block_engaged(jspec, s, train=train)), s


def test_fused_grads_match_jax_custom_vjp():
    """dx and every dparam of the port's fused block (recompute backward)
    against `jax.vjp` of the JAX fused block (custom VJP, Pallas forward in
    interpret mode): 2e-5 on dx, 1e-4 on the params, the bounds
    tests/test_roofline.py holds the fused VJP to."""
    b, s, d, h, r = 3, 9, 16, 2, 2
    rng = np.random.default_rng(77)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    p = _params(rng, d, r)
    dy = rng.normal(size=(b, s, d)).astype(np.float32)
    jspec, tspec = _specs(d, h, r)
    names = list(p)
    _, vjp = jax.vjp(
        lambda x_, *flat: jax_ftb.fused_transformer_block(
            x_, dict(zip(names, flat)), jspec),
        jnp.asarray(x), *(jnp.asarray(p[n]) for n in names))
    want = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {n: torch.from_numpy(p[n]).requires_grad_(True) for n in names}
    out = ft_block.fused_transformer_block(tx, tp, tspec)
    got = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(dy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    for n, a, w in zip(names, got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_fused_grads_reach_bf16_tokens_and_f32_params():
    """A bf16 block input gets a bf16 gradient through the f32 kernel; the
    f32 params get f32 gradients."""
    b, s, d, h, r = 2, 5, 8, 2, 1
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    xb = x.to(torch.bfloat16).requires_grad_(True)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in _params(rng, d, r).items()}
    out = ft_block.fused_transformer_block(xb, p, _specs(d, h, r)[1])
    out.float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    assert all(t.grad is not None and t.grad.dtype == torch.float32
               for t in p.values())


def test_kill_switch(monkeypatch):
    """The JAX package's kill switch does not reach the port: on the card
    `fused_block="off"` is the one way to the unfused block."""
    monkeypatch.setenv("SHIFU_TPU_NO_FT_FUSED", "1")
    assert ft_block.ft_block_applicable(31, 64, 8, 4)
    assert ft_block.fused_block_engaged(_specs(64, 8, 4)[1], 31)


@pytest.mark.parametrize("bad", ["seq", "dim", "heads", "param_shape",
                                 "rank"])
def test_out_of_envelope_raises(bad):
    b, s, d, h, r = 2, 9, 16, 2, 2
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, r).items()}
    x = torch.zeros(b, s, d)
    spec = _specs(d, h, r)[1]
    if bad == "seq":
        x = torch.zeros(b, ft_block.MAX_TOKENS + 1, d)
    elif bad == "dim":
        x = torch.zeros(b, s, d + 1)
    elif bad == "heads":
        spec = _specs(d, 3, r)[1]
    elif bad == "param_shape":
        p["qkv_kernel"] = torch.zeros(d, 2 * d)
    else:
        x = torch.zeros(s, d)
    with pytest.raises(ValueError):
        ft_block.fused_transformer_block(x, p, spec)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_kernel_sources_listed():
    assert set(_build.sources()) == {"ft_block", "small_attention",
                                     "int8_matmul", "flash_fwd",
                                     "flash_bwd_dq", "flash_bwd_dkv",
                                     "embedding_lookup", "rows_update"}
