"""Inputs and weights from the seed, made on the device in a few large
calls: the one generator every traffic file and configuration is read by.

Each stream (rows, teacher, weights) has a `torch.Generator` of its own on
the device, seeded from (seed, stream), so one seed gives the same inputs
in every run and the streams do not overlap.  Every seed gives the same
sizes; only the values differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAM_ROWS, STREAM_TEACHER, STREAM_WEIGHTS = 1, 2, 3
_TEACHER_CHUNK = 1 << 20


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def batch_order(seed: int, n_batches: int) -> np.ndarray:
    """The seeded order in which whole batches are taken."""
    return np.random.default_rng(int(seed)).permutation(n_batches)


def numeric_rows(n: int, n_features: int, seed: int, device) -> torch.Tensor:
    """(n, F) float32 z-scaled features: standard normals, what Shifu's
    ZSCALE normalisation gives a numeric column."""
    return torch.randn((n, n_features), generator=generator(
        seed, STREAM_ROWS, device), device=device, dtype=torch.float32)


def teacher_labels(x: torch.Tensor, seed: int, hidden: int) -> torch.Tensor:
    """(n, 1) float32 0/1 labels drawn from a seeded one-hidden-layer
    teacher, so that the loss has something to learn."""
    dev, f = x.device, x.shape[1]
    g = generator(seed, STREAM_TEACHER, dev)
    w1 = torch.randn((f, hidden), generator=g, device=dev) / math.sqrt(f)
    b1 = 0.5 * torch.randn((hidden,), generator=g, device=dev)
    w2 = 3.0 * torch.randn((hidden, 1), generator=g, device=dev) \
        / math.sqrt(hidden)
    u = torch.rand((x.shape[0], 1), generator=g, device=dev)
    out = torch.empty((x.shape[0], 1), device=dev, dtype=torch.float32)
    for lo in range(0, x.shape[0], _TEACHER_CHUNK):
        hi = min(lo + _TEACHER_CHUNK, x.shape[0])
        logit = torch.tanh(x[lo:hi] @ w1 + b1) @ w2
        out[lo:hi] = (u[lo:hi] < torch.sigmoid(logit)).float()
    return out


def ft_param_shapes(cfg: dict) -> dict[str, tuple]:
    """The FT-Transformer's parameters by the port's state_dict names,
    with their shapes; the reference reads the same names."""
    d, r, f = cfg["token_dim"], cfg["mlp_ratio"], cfg["n_num_features"]
    shapes = {"cls_token": (1, 1, d), "numeric_tokenizer.weight": (f, d),
              "numeric_tokenizer.bias": (f, d)}
    for i in range(cfg["num_layers"]):
        b = f"block_{i}."
        shapes.update({
            b + "ln_attn.scale": (d,), b + "ln_attn.bias": (d,),
            b + "qkv.kernel": (d, 3 * d), b + "qkv.bias": (3 * d,),
            b + "proj.kernel": (d, d), b + "proj.bias": (d,),
            b + "ln_mlp.scale": (d,), b + "ln_mlp.bias": (d,),
            b + "mlp_in.kernel": (d, r * d), b + "mlp_in.bias": (r * d,),
            b + "mlp_out.kernel": (r * d, d), b + "mlp_out.bias": (d,)})
    shapes.update({"ln_final.scale": (d,), "ln_final.bias": (d,),
                   "shifu_output_0.Dense_0.kernel": (d, cfg["num_heads"]),
                   "shifu_output_0.Dense_0.bias": (cfg["num_heads"],)})
    return shapes


def _half_width(name: str, shape: tuple, d: int) -> float:
    """Half-width of the uniform draw of one parameter: xavier for a
    kernel, 1/sqrt(d) for the tokenizer and CLS token (rtdl's init),
    small for biases and the LayerNorms' shifts."""
    if name.endswith(".kernel"):
        return math.sqrt(6.0 / (shape[0] + shape[1]))
    if name.startswith(("numeric_tokenizer", "cls_token")):
        return 1.0 / math.sqrt(d)
    if name.endswith(".scale"):
        return 0.1
    return 0.05


def ft_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The model's float32 weights, drawn from the seed on `device` in one
    call and cut into leaves: uniform in +-half-width, LayerNorm scales
    around 1."""
    shapes = ft_param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand((sum(sizes),), generator=generator(
        seed, STREAM_WEIGHTS, device), device=device, dtype=torch.float32)
    flat = 2.0 * flat - 1.0
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        w = _half_width(name, shape, cfg["token_dim"]) * part.view(shape)
        out[name] = (1.0 + w) if name.endswith(".scale") else w
    return out
