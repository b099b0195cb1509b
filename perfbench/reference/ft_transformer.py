"""The plain reference of the FT-Transformer as the benchmark's
configurations run it, in plain PyTorch: the forward pass, the BCE loss,
its gradients and AdamW, with no kernel, cache or batching of the program.

It follows the configuration files under `perfbench/configs/` (the
published model with the departures they list): numeric tokens x_j * w_j
+ b_j, a CLS token first, pre-LN blocks (LayerNorm, QKV, softmax attention
per head, projection, residual, LayerNorm, tanh-GELU FFN, residual), a
final LayerNorm of the CLS token and a linear head.  Parameters are a dict
of float32 tensors under the port's state_dict names, which the benchmark
draws from the seed and hands to both sides.

`precision` is "f32" (TF32 off: every product in true float32) or "fp8",
the control: every matrix product takes its two operands rounded to
float8 e4m3 with one scale a tensor (the tensor's largest magnitude onto
e4m3's largest, 448), and in the backward the incoming gradient rounded to
float8 e5m2 likewise; the elementwise work stays float32.  That is the
step below the configurations' bfloat16 compute that a change to the
program might take.

This module imports torch alone.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_f32():
    """Every float32 product in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t: torch.Tensor, dtype=torch.float8_e4m3fn,
              fmax: float = E4M3_MAX) -> torch.Tensor:
    """`t` rounded to a float8 type under one per-tensor scale, returned
    in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = fmax / amax
    return (t * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = fp8_round(g, torch.float8_e5m2, E5M2_MAX)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


def _matmul(precision: str):
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def _layer_norm(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".scale"],
                        p[name + ".bias"], eps)


def _block(h, p, i, cfg, mm):
    n, s, d = h.shape
    heads = cfg["num_attention_heads"]
    dh = d // heads
    eps = cfg["ln_eps"]
    b = f"block_{i}."
    y = _layer_norm(h, p, b + "ln_attn", eps).reshape(n * s, d)
    qkv = mm(y, p[b + "qkv.kernel"]) + p[b + "qkv.bias"]
    q, k, v = (t.reshape(n, s, heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    attn = mm(torch.softmax(scores, dim=-1), v)
    attn = attn.transpose(1, 2).reshape(n * s, d)
    h = h + (mm(attn, p[b + "proj.kernel"]) + p[b + "proj.bias"]).view(
        n, s, d)
    y = _layer_norm(h, p, b + "ln_mlp", eps).reshape(n * s, d)
    y = F.gelu(mm(y, p[b + "mlp_in.kernel"]) + p[b + "mlp_in.bias"],
               approximate="tanh")
    y = mm(y, p[b + "mlp_out.kernel"]) + p[b + "mlp_out.bias"]
    return h + y.view(n, s, d)


def logits(p: dict, x: torch.Tensor, cfg: dict,
           precision: str = "f32") -> torch.Tensor:
    """(N, F) float32 features -> (N, heads) float32 logits."""
    mm = _matmul(precision)
    x = x.float()
    tokens = x[:, :, None] * p["numeric_tokenizer.weight"] \
        + p["numeric_tokenizer.bias"]
    cls = p["cls_token"].expand(x.shape[0], 1, -1)
    h = torch.cat([cls, tokens], dim=1)
    for i in range(cfg["num_layers"]):
        h = _block(h, p, i, cfg, mm)
    c = _layer_norm(h[:, 0], p, "ln_final", cfg["ln_eps"])
    return mm(c, p["shifu_output_0.Dense_0.kernel"]) \
        + p["shifu_output_0.Dense_0.bias"]


def probabilities(p: dict, x: torch.Tensor, cfg: dict,
                  precision: str = "f32",
                  block_rows: int = 65536) -> torch.Tensor:
    """sigmoid(logits) of every row, in blocks of `block_rows` so that the
    reference fits beside what it judges."""
    out = torch.empty((x.shape[0], cfg["num_heads"]), dtype=torch.float32,
                      device=x.device)
    with exact_f32(), torch.no_grad():
        for lo in range(0, x.shape[0], block_rows):
            hi = min(lo + block_rows, x.shape[0])
            out[lo:hi] = torch.sigmoid(logits(p, x[lo:hi], cfg, precision))
    return out


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of logits z against 0/1 y."""
    return F.binary_cross_entropy_with_logits(z.float(), y.float())


def gradient(p: dict, x: torch.Tensor, y: torch.Tensor, cfg: dict,
             precision: str = "f32") -> dict:
    """The mean BCE loss's gradient at the weights `p` on one batch."""
    params = {k: v.detach().float().requires_grad_(True)
              for k, v in p.items()}
    with exact_f32():
        loss = bce(logits(params, x, cfg, precision), y)
        grads = torch.autograd.grad(loss, list(params.values()))
    return {k: g.detach() for k, g in zip(params, grads)}


def train(p0: dict, batches: list, cfg: dict, precision: str = "f32"
          ) -> dict:
    """AdamW (decoupled weight decay added to the Adam direction, then
    scaled by the learning rate) over `batches` [(x, y), ...] from the
    weights `p0`.  Returns each step's loss, the first step's gradients and
    the weights after the last step, all float32."""
    opt = cfg["optimizer"]
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    with exact_f32():
        for t, (x, y) in enumerate(batches, start=1):
            loss = bce(logits(params, x, cfg, precision), y)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if first_grads is None:
                    first_grads = {k: g.detach().clone()
                                   for k, g in zip(params, grads)}
                c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                for (k, w), g in zip(params.items(), grads):
                    mu[k] = b1 * mu[k] + (1.0 - b1) * g
                    nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
                    update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                    w -= lr * (update + wd * w)
    return {"losses": losses, "grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}}
