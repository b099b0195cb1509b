"""FT-Transformer tabular model (port of shifu_tpu/models/ft_transformer.py,
single device: scoring and training).

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

`remat=True` recomputes each block's activations in the backward pass
(`torch.utils.checkpoint`, non-reentrant), as `nn.remat` does in JAX.
The dropout masks come from the model's own generator, which
checkpointing does not preserve, so each block restores that generator's
state before it runs: the recompute draws the masks of the forward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.schema import ModelSpec
from ..ops.attention import mha
from ..ops.flash_attention import flash_attention
from ..ops.ft_block import fused_block_engaged, fused_transformer_block
from ..ops.initializers import xavier_uniform
from ..ops.small_attention import (small_attention_applicable,
                                   small_token_attention)
from .base import Dense, Dropout, ShifuDense, cat_promoted, dtype_of
from .embedding import (CategoricalEmbed, FieldLayout, NumericEmbed,
                        split_features)

LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)


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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, r, cdt = spec.token_dim, spec.mlp_ratio, spec.compute_dtype
        pdt = spec.param_dtype
        if d % spec.num_attention_heads != 0:
            raise ValueError(
                f"token_dim ({d}) must be divisible by num_attention_heads "
                f"({spec.num_attention_heads})")
        self.spec = spec
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
        if fused_block_engaged(spec, s, train=self.training):
            return fused_transformer_block(x, self.fused_params(), spec)

        y = self.ln_attn(x)
        q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2).contiguous()
                   for t in self.qkv(y).split(d, dim=-1))
        if spec.attention_impl == "flash":
            attn = flash_attention(q, k, v)
        elif small_attention_applicable(s, d // h, h):
            attn = small_token_attention(q, k, v)
        else:
            attn = mha(q, k, v)
        attn = attn.transpose(1, 2).reshape(b, s, d)
        x = x + self.drop_attn(self.proj(attn))

        y = self.mlp_in(self.ln_mlp(x))
        y = self.mlp_out(F.gelu(y, approximate="tanh"))
        return x + self.drop_mlp(y)


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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={spec.attention_impl!r} is not ported yet "
                "(ROADMAP.md, queue A item (f): sequence parallelism); use "
                "'local' or 'flash'")
        if spec.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline_stages > 1 is not ported yet (ROADMAP.md, queue "
                "A item (f)); export the canonical per-block artifact")
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
        for i in range(spec.num_layers):
            self.add_module(f"block_{i}", TransformerBlock(spec, generator))
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
        remat = self.spec.remat and torch.is_grad_enabled()
        for i in range(self.spec.num_layers):
            block = getattr(self, f"block_{i}")
            x = _remat(block, x) if remat else block(x)
        cls_out = self.ln_final(x[:, 0, :])
        return self.shifu_output_0(cls_out).float()
