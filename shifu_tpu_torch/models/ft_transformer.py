"""FT-Transformer tabular model (port of shifu_tpu/models/ft_transformer.py:
scoring and training, on one device or on a mesh).

Feature Tokenizer + Transformer: every selected column becomes a token
(numeric: x_j * w_j + b_j; categorical: table lookup), a CLS token is
prepended, L pre-LN transformer blocks attend over the feature axis, and
the CLS representation feeds the `shifu_output_0` head.

Each block runs fused (`ops/ft_block`: the CUDA kernel on the card, its
plain twin on the CPU) when `fused_block_engaged` says so, else through the
unfused module math, whose attention takes `ops/flash_attention` when
`attention_impl="flash"`, `ops/small_attention` for the shapes its gate
admits, and `ops/attention.mha` for the rest.  As in JAX, a block with
dropout is not fused in training, and the unfused block drops out after
`proj` and after `mlp_out`.  Both branches read the same parameters under
the same names (`block_{i}/qkv/kernel`, ...), which are the names of an
exported artifact; the dropout modules hold none.

With `attention_impl` "ring" or "ulysses" and a mesh whose `seq` axis is
above 1, each rank computes the attention of its S/n query tokens
(ops/attention.py) and all-gathers the result over `seq`; the rest of the
block runs whole on every rank, as in JAX.  Without such an axis those
specs take the local route.

`pipeline_stages > 1` holds the trunk as `StackedBlocks`: the block leaves
stacked (L, ...) under `blocks.<name>`, run as one loop over the layers
(`_block_forward`, fused where the gate admits) or, with a `pipe` axis
above 1, through parallel/pipeline.pipeline_apply.  `canonicalize_params`
and `stack_block_params` convert between the two layouts; the artifact is
always the per-block one.  The stacked trunk draws its initial weights in
the per-block model's order, so one seed gives the same weights in both.

`remat=True` recomputes each block's activations in the backward pass
(`torch.utils.checkpoint`, non-reentrant), as `nn.remat` does in JAX.
The dropout masks come from the model's own generator, which
checkpointing does not preserve, so each block restores that generator's
state before it runs: the recompute draws the masks of the forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.schema import ModelSpec
from ..ops.attention import mha, ring_attention, ulysses_attention
from ..ops.flash_attention import flash_attention
from ..ops.ft_block import fused_block_engaged, fused_transformer_block
from ..ops.initializers import xavier_uniform
from ..ops.small_attention import (small_attention_applicable,
                                   small_token_attention)
from ..parallel.distributed import gather_grad
from ..parallel.mesh import PIPE_AXIS, SEQ_AXIS
from ..parallel.pipeline import n_microbatches, pipeline_apply
from .base import Dense, Dropout, ShifuDense, cat_promoted, dtype_of
from .embedding import (CategoricalEmbed, FieldLayout, NumericEmbed,
                        split_features)

LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)


def _axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.axis_size(axis)


class LayerNorm(nn.Module):
    """Counterpart of flax `nn.LayerNorm(dtype=cdt)`: params `scale` and
    `bias` (float32); statistics in float32 with Flax's fast variance
    E[x^2] - E[x]^2 (clipped at 0), eps 1e-6, output in `cdt`."""

    def __init__(self, dim: int, compute_dtype: str = "bfloat16"):
        super().__init__()
        self.cdt = dtype_of(compute_dtype)
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp(min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.scale)
        return (y + self.bias).to(self.cdt)


class TransformerBlock(nn.Module):
    """One pre-LN block: LN -> QKV -> attention -> proj -> dropout ->
    residual -> LN -> FFN (tanh-gelu) -> dropout -> residual."""

    def __init__(self, spec: ModelSpec,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        d, r, cdt = spec.token_dim, spec.mlp_ratio, spec.compute_dtype
        pdt = spec.param_dtype
        if d % spec.num_attention_heads != 0:
            raise ValueError(
                f"token_dim ({d}) must be divisible by num_attention_heads "
                f"({spec.num_attention_heads})")
        self.spec = spec
        self.mesh = mesh  # ring/Ulysses attention when its seq axis > 1
        self.ln_attn = LayerNorm(d, cdt)
        self.qkv = Dense(d, 3 * d, cdt, generator=generator, param_dtype=pdt)
        self.proj = Dense(d, d, cdt, generator=generator, param_dtype=pdt)
        self.ln_mlp = LayerNorm(d, cdt)
        self.mlp_in = Dense(d, r * d, cdt, generator=generator,
                            param_dtype=pdt)
        self.mlp_out = Dense(r * d, d, cdt, generator=generator,
                             param_dtype=pdt)
        self.drop_attn = Dropout(spec.dropout_rate)
        self.drop_mlp = Dropout(spec.dropout_rate)

    def fused_params(self) -> dict:
        """The stacked-name dict the fused block takes."""
        return {f"{mod}_{leaf}": getattr(getattr(self, mod), leaf)
                for mod in ("ln_attn", "qkv", "proj", "ln_mlp", "mlp_in",
                            "mlp_out")
                for leaf in (("scale", "bias") if mod.startswith("ln")
                             else ("kernel", "bias"))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        b, s, d = x.shape
        h = spec.num_attention_heads
        n_sp = _axis_size(self.mesh, SEQ_AXIS)
        if fused_block_engaged(spec, s, train=self.training,
                               n_seq_parallel=n_sp):
            return fused_transformer_block(x, self.fused_params(), spec)

        y = self.ln_attn(x)
        q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2).contiguous()
                   for t in self.qkv(y).split(d, dim=-1))
        if spec.attention_impl == "flash":
            attn = flash_attention(q, k, v)
        elif spec.attention_impl != "local" and n_sp > 1:
            attn = _seq_parallel_attention(q, k, v, spec, self.mesh)
        elif small_attention_applicable(s, d // h, h):
            attn = small_token_attention(q, k, v)
        else:
            attn = mha(q, k, v)
        attn = attn.transpose(1, 2).reshape(b, s, d)
        x = x + self.drop_attn(self.proj(attn))

        y = self.mlp_in(self.ln_mlp(x))
        y = self.mlp_out(F.gelu(y, approximate="tanh"))
        return x + self.drop_mlp(y)


def _seq_parallel_attention(q, k, v, spec: ModelSpec, mesh) -> torch.Tensor:
    """Ring or Ulysses attention of this rank's S/n query tokens over the
    `seq` axis, all-gathered (with a gradient) into the whole (B, H, S,
    dh) output."""
    n_sp = mesh.axis_size(SEQ_AXIS)
    s = q.shape[2]
    if s % n_sp != 0:
        raise ValueError(
            f"attention_impl={spec.attention_impl!r} needs the token count "
            f"({s}) divisible by the seq mesh axis ({n_sp}); pad features "
            "or adjust the mesh")
    blk = s // n_sp
    lo = mesh.axis_index(SEQ_AXIS) * blk
    fn = ring_attention if spec.attention_impl == "ring" \
        else ulysses_attention
    out = fn(*(t[:, :, lo:lo + blk] for t in (q, k, v)), mesh)
    return gather_grad(out, mesh.group(SEQ_AXIS), 2)


# -- the stacked trunk ----------------------------------------------------------

# stacked param name -> (module, leaf) inside block_{i}
_BLOCK_PARAM_PATHS = {
    "ln_attn_scale": ("ln_attn", "scale"), "ln_attn_bias": ("ln_attn", "bias"),
    "qkv_kernel": ("qkv", "kernel"), "qkv_bias": ("qkv", "bias"),
    "proj_kernel": ("proj", "kernel"), "proj_bias": ("proj", "bias"),
    "ln_mlp_scale": ("ln_mlp", "scale"), "ln_mlp_bias": ("ln_mlp", "bias"),
    "mlp_in_kernel": ("mlp_in", "kernel"), "mlp_in_bias": ("mlp_in", "bias"),
    "mlp_out_kernel": ("mlp_out", "kernel"),
    "mlp_out_bias": ("mlp_out", "bias"),
}


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               cdt: torch.dtype) -> torch.Tensor:
    """The JAX `_layernorm` of the stacked trunk: float32 statistics with
    the two-pass variance (jnp.var), eps 1e-6, output in `cdt`."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(cdt)


def _block_forward(p: dict, x: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """One pre-LN block as a function of the stacked-name param dict: the
    math of the JAX `_block_forward`, which the stacked and pipelined
    trunks run.  It has no dropout (pipelining requires dropout 0) and is
    fused wherever the gate admits the shape."""
    cdt = dtype_of(spec.compute_dtype)
    b, s, d = x.shape
    h = spec.num_attention_heads
    if fused_block_engaged(spec, s):
        return fused_transformer_block(x, p, spec)

    def dense(y, name):
        return (y.to(cdt) @ p[f"{name}_kernel"].to(cdt)
                + p[f"{name}_bias"].to(cdt))

    y = _layernorm(x, p["ln_attn_scale"], p["ln_attn_bias"], cdt)
    q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2).contiguous()
               for t in dense(y, "qkv").split(d, dim=-1))
    if spec.attention_impl == "flash":
        attn = flash_attention(q, k, v)
    elif small_attention_applicable(s, d // h, h):
        attn = small_token_attention(q, k, v)
    else:
        attn = mha(q, k, v)
    x = x + dense(attn.transpose(1, 2).reshape(b, s, d), "proj")
    y = _layernorm(x, p["ln_mlp_scale"], p["ln_mlp_bias"], cdt)
    y = dense(F.gelu(dense(y, "mlp_in"), approximate="tanh"), "mlp_out")
    return x + y


def make_stage_fn(spec: ModelSpec):
    """stage_fn(params, h) for parallel/pipeline.pipeline_apply: the
    stage's (n, ...) stacked layers applied in order, each through
    `_block_forward`; with spec.remat each block recomputes its
    activations in the backward pass."""
    def stage_fn(params: dict, h: torch.Tensor) -> torch.Tensor:
        n = next(iter(params.values())).shape[0]
        remat = spec.remat and torch.is_grad_enabled()
        for i in range(n):
            p = {k: v[i] for k, v in params.items()}
            if remat:
                h = checkpoint(lambda hh, _p=p: _block_forward(_p, hh, spec),
                               h, use_reentrant=False)
            else:
                h = _block_forward(p, h, spec)
        return h
    return stage_fn


class StackedBlocks(nn.Module):
    """The trunk with layer-stacked parameters (leaves (L, ...), named
    `blocks.<name>`).  With a `pipe` mesh axis above 1 the leaves are
    split by stage (`accept_split`; train/loop.init_state places them)
    and microbatches flow through `pipeline_apply`; otherwise the layers
    run as one loop.  Init draws each layer as `TransformerBlock` does, in
    the per-block model's order."""

    def __init__(self, spec: ModelSpec,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.spec = spec
        self.mesh = mesh
        self.stage_split: set = set()
        layers = [TransformerBlock(spec, generator)
                  for _ in range(spec.num_layers)]
        for name, (mod, leaf) in _BLOCK_PARAM_PATHS.items():
            self.register_parameter(name, nn.Parameter(torch.stack(
                [getattr(getattr(b, mod), leaf).detach() for b in layers])))

    def accept_split(self, leaf: str, sharding) -> bool:
        """Take a leaf split by stage over `pipe` as this stage's layers."""
        spec = tuple(sharding.spec)
        if spec[:1] == (PIPE_AXIS,) and not any(spec[1:]):
            self.stage_split.add(leaf)
            return True
        return False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        params = {name: getattr(self, name) for name in _BLOCK_PARAM_PATHS}
        stage_fn = make_stage_fn(spec)
        n_pipe = _axis_size(self.mesh, PIPE_AXIS)
        if n_pipe <= 1:
            return stage_fn(params, x)
        lps = spec.num_layers // n_pipe
        lo = self.mesh.axis_index(PIPE_AXIS) * lps
        local = {k: (v if k in self.stage_split else v[lo:lo + lps])
                 for k, v in params.items()}
        n_micro = n_microbatches(spec)
        b = x.shape[0]
        if b % n_micro != 0:
            raise ValueError(
                f"pipeline needs batch ({b}) divisible by microbatch count "
                f"({n_micro}); adjust batch_size or pipeline_microbatches")
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        out = pipeline_apply(stage_fn, local, micro, self.mesh)
        return out.reshape(b, *x.shape[1:])


def _is_block_key(key: str) -> bool:
    head = key.split(".", 1)[0]
    return head.startswith("block_") and head[6:].isdigit()


def _stack(parts: list):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts)
    return np.stack([np.asarray(p) for p in parts])


def stack_block_params(params: dict, spec: ModelSpec) -> dict:
    """Inverse of `canonicalize_params`: fold the per-block
    `block_{i}.<module>.<leaf>` entries of a flat (state_dict-named) dict
    into the stacked `blocks.<name>` (L, ...) leaves, so that a per-block
    checkpoint restores into a stacked trunk (the two layouts are views of
    the same weights).  A stacked dict passes through."""
    if any(k.startswith("blocks.") for k in params):
        return params
    out = {k: v for k, v in params.items() if not _is_block_key(k)}
    for name, (mod, leaf) in _BLOCK_PARAM_PATHS.items():
        out[f"blocks.{name}"] = _stack(
            [params[f"block_{i}.{mod}.{leaf}"]
             for i in range(spec.num_layers)])
    return out


def canonicalize_params(params: dict, spec: ModelSpec) -> dict:
    """A stacked (`blocks.<name>` (L, ...)) flat dict -> the per-block
    `block_{i}.<module>.<leaf>` dict that the export program references,
    so that a pipeline-trained model ships the same artifact as a
    one-device one.  A per-block dict passes through."""
    if not any(k.startswith("blocks.") for k in params):
        return params
    out = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    for i in range(spec.num_layers):
        for name, (mod, leaf) in _BLOCK_PARAM_PATHS.items():
            out[f"block_{i}.{mod}.{leaf}"] = params[f"blocks.{name}"][i]
    return out


def _remat(block: TransformerBlock, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` under non-reentrant checkpointing, with the state of each
    dropout generator restored before the first run and the recompute."""
    gens = list({id(m.generator): m.generator for m in block.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 }.values())
    states = [g.get_state() for g in gens]

    def run(inp: torch.Tensor) -> torch.Tensor:
        for g, st in zip(gens, states):
            g.set_state(st)
        return block(inp)

    return checkpoint(run, x, use_reentrant=False)


class FTTransformer(nn.Module):
    def __init__(self, spec: ModelSpec, layout: FieldLayout,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        if spec.pipeline_stages > 1 and _axis_size(mesh, SEQ_AXIS) > 1:
            raise ValueError("pipeline_stages > 1 does not compose with a "
                             "seq mesh axis; use one or the other")
        self.spec = spec
        self.layout = layout
        d, cdt, pdt = spec.token_dim, spec.compute_dtype, spec.param_dtype
        self.cdt = dtype_of(cdt)
        if layout.num_numeric:
            self.numeric_tokenizer = NumericEmbed(layout, d, cdt, generator,
                                                  pdt)
        if layout.num_categorical:
            self.cat_tokenizer = CategoricalEmbed(layout, d, cdt, generator,
                                                  pdt)
        self.cls_token = nn.Parameter(
            xavier_uniform((1, 1, d), generator).to(dtype_of(pdt)))
        if spec.pipeline_stages > 1:
            self.blocks = StackedBlocks(spec, generator, mesh)
        else:
            for i in range(spec.num_layers):
                self.add_module(f"block_{i}",
                                TransformerBlock(spec, generator, mesh))
        self.ln_final = LayerNorm(d, cdt)
        self.shifu_output_0 = ShifuDense(d, spec.num_heads, None,
                                         spec.xavier_bias_init, cdt,
                                         generator, param_dtype=pdt)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        numeric, ids = split_features(features, self.layout)
        tokens = []
        if self.layout.num_numeric:
            tokens.append(self.numeric_tokenizer(numeric))
        if self.layout.num_categorical:
            tokens.append(self.cat_tokenizer(ids))
        # numeric tokens are float32 under f32 params (promotion); the
        # concat promotes the categorical ones with them before the cast
        x = cat_promoted(tokens, dim=1)
        cls = self.cls_token.to(self.cdt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x.to(self.cdt)], dim=1).contiguous()
        if self.spec.pipeline_stages > 1:
            x = self.blocks(x)
        else:
            remat = self.spec.remat and torch.is_grad_enabled()
            for i in range(self.spec.num_layers):
                block = getattr(self, f"block_{i}")
                x = _remat(block, x) if remat else block(x)
        cls_out = self.ln_final(x[:, 0, :])
        return self.shifu_output_0(cls_out).float()
