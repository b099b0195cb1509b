"""Artifact op-list programs (format v2): every ladder model lowered to a
portable tensor program (a copy of shifu_tpu/export/program.py over the
port's own `models/embedding.FieldLayout`).

An SSA-style op list over named buffers -- `input` is the (B, F) feature
matrix; each op reads buffers and writes one -- that the port's numpy
interpreter (export/scorer.py `run_program`) and the JAX package's numpy
and native C++ scorers execute.  For the same spec and schema the program
is the JAX package's, op for op, so an artifact the port writes scores in
every engine of both packages.

Op set (all scoring math is float32):
  gather_cols   (B,F) -> (B,P)        select columns by position
  dense         (B,I) -> (B,O)        x @ kernel + bias, fused activation
  embed_lookup  (B,F) -> (B,Nc,D)     per-field id clip + stacked-table gather
  numeric_embed (B,Nn) -> (B,Nn,D)    x[:,:,None]*w + b
  concat        axis-1 concat of equal-rank buffers (features or tokens)
  flatten       (B,S,D) -> (B,S*D)
  sum_fields    (B,S,D) -> (B,D)      sum over the field/token axis
  add           elementwise sum; (B,1) operands broadcast over heads
  fm_pair       (B,S,D) -> (B,1)      0.5*sum((sum_f v)^2 - sum_f v^2)
  activation    elementwise fn (incl. gelu-tanh for transformer MLPs)
  cls_prepend   (B,S,D) -> (B,S+1,D)  prepend the learned CLS token
  layernorm     last-axis LN, eps 1e-6
  select_token  (B,S,D) -> (B,D)      take token at index
  transformer_block                   pre-LN MHA + residual + pre-LN MLP
  expert_dense  (B,I)|(B,E,I) -> (B,E,O)  per-expert x @ K[e] + b[e], fused
                                      activation (the MoE's expert trunks)
  moe_combine   (B,E,H) x (B,E) -> (B,H)  gate-weighted expert combination
"""

from __future__ import annotations

from typing import Any, Optional

from ..config.schema import DataSchema, ModelSpec
from ..models.embedding import FieldLayout, field_layout

PROGRAM_VERSION = 2

Op = dict[str, Any]

# weight-reference fields per op type (for artifact validation + native pack)
WEIGHT_FIELDS: dict[str, tuple[str, ...]] = {
    "dense": ("kernel", "bias"),
    "embed_lookup": ("table",),
    "numeric_embed": ("weight", "bias"),
    "cls_prepend": ("token",),
    "layernorm": ("scale", "bias"),
    "expert_dense": ("kernel", "bias"),
    "transformer_block": (
        "ln_attn_scale", "ln_attn_bias", "qkv_kernel", "qkv_bias",
        "proj_kernel", "proj_bias", "ln_mlp_scale", "ln_mlp_bias",
        "mlp_in_kernel", "mlp_in_bias", "mlp_out_kernel", "mlp_out_bias"),
}


def weight_keys(program: list[Op]) -> list[str]:
    """All weights.npz keys a program references."""
    keys = []
    for op in program:
        for field in WEIGHT_FIELDS.get(op["op"], ()):
            keys.append(op[field])
    return keys


def _dense(src: str, out: str, prefix: str, activation: Optional[str]) -> Op:
    return {"op": "dense", "src": src, "out": out,
            "kernel": f"{prefix}/kernel", "bias": f"{prefix}/bias",
            "activation": activation}


def _trunk(src: str, spec: ModelSpec, scope: str = "trunk") -> tuple[list[Op], str]:
    ops = []
    cur = src
    for i, act in enumerate(spec.activations):
        nxt = f"{scope}_h{i}"
        ops.append(_dense(cur, nxt, f"{scope}/hidden_layer{i}/Dense_0", act))
        cur = nxt
    return ops, cur


def _embed(layout: FieldLayout, table_key: str, out: str) -> Op:
    return {"op": "embed_lookup", "src": "input", "out": out,
            "table": table_key,
            "positions": list(layout.categorical_positions),
            "vocabs": list(layout.vocab_sizes)}


def _numeric(src: str, out: str, prefix: str) -> Op:
    return {"op": "numeric_embed", "src": src, "out": out,
            "weight": f"{prefix}/weight", "bias": f"{prefix}/bias"}


def _gather_numeric(layout: FieldLayout) -> Op:
    return {"op": "gather_cols", "src": "input", "out": "numeric",
            "positions": list(layout.numeric_positions)}


def _sigmoid(src: str) -> Op:
    return {"op": "activation", "src": src, "out": "score", "fn": "sigmoid"}


def _mlp_program(spec: ModelSpec, layout: FieldLayout) -> list[Op]:
    """models/mlp.py ShifuMLP: trunk over all features + named head."""
    ops, cur = _trunk("input", spec)
    ops.append(_dense(cur, "logits", "head/shifu_output_0/Dense_0", None))
    ops.append(_sigmoid("logits"))
    return ops


def _wide_deep_program(spec: ModelSpec, layout: FieldLayout) -> list[Op]:
    """models/wide_deep.py WideDeep forward, op for op."""
    ops: list[Op] = [_gather_numeric(layout)]
    ops.append(_dense("numeric", "wide_num", "wide_linear/Dense_0", None))
    wide = "wide_num"
    deep_in = "numeric"
    if layout.num_categorical:
        ops.append(_embed(layout, "wide_cat_embedding/embedding", "wide_cat"))
        ops.append({"op": "sum_fields", "src": "wide_cat", "out": "wide_cat_sum"})
        ops.append({"op": "add", "srcs": ["wide_num", "wide_cat_sum"],
                    "out": "wide"})
        wide = "wide"
        ops.append(_embed(layout, "deep_embedding/embedding", "deep_emb"))
        ops.append({"op": "flatten", "src": "deep_emb", "out": "deep_emb_flat"})
        ops.append({"op": "concat", "srcs": ["numeric", "deep_emb_flat"],
                    "out": "deep_in"})
        deep_in = "deep_in"
    trunk_ops, cur = _trunk(deep_in, spec)
    ops.extend(trunk_ops)
    ops.append(_dense(cur, "deep", "shifu_output_0/Dense_0", None))
    ops.append({"op": "add", "srcs": [wide, "deep"], "out": "logits"})
    ops.append(_sigmoid("logits"))
    return ops


def _deepfm_program(spec: ModelSpec, layout: FieldLayout) -> list[Op]:
    """models/deepfm.py DeepFM: first-order + FM pairwise + deep trunk."""
    ops: list[Op] = [_gather_numeric(layout)]
    vec_bufs = []
    if layout.num_numeric:
        ops.append(_numeric("numeric", "num_vecs", "numeric_embedding"))
        vec_bufs.append("num_vecs")
    if layout.num_categorical:
        ops.append(_embed(layout, "cat_embedding/embedding", "cat_vecs"))
        vec_bufs.append("cat_vecs")
    ops.append({"op": "concat", "srcs": vec_bufs, "out": "vecs"})

    ops.append(_dense("numeric", "first_num", "first_order_numeric/Dense_0",
                      None))
    first = "first_num"
    if layout.num_categorical:
        ops.append(_embed(layout, "first_order_cat/embedding", "first_cat"))
        ops.append({"op": "sum_fields", "src": "first_cat",
                    "out": "first_cat_sum"})
        ops.append({"op": "add", "srcs": ["first_num", "first_cat_sum"],
                    "out": "first"})
        first = "first"

    ops.append({"op": "fm_pair", "src": "vecs", "out": "fm"})

    ops.append({"op": "flatten", "src": "vecs", "out": "vecs_flat"})
    trunk_ops, cur = _trunk("vecs_flat", spec)
    ops.extend(trunk_ops)
    ops.append(_dense(cur, "deep", "shifu_output_0/Dense_0", None))

    ops.append({"op": "add", "srcs": [first, "fm", "deep"], "out": "logits"})
    ops.append(_sigmoid("logits"))
    return ops


def _multitask_program(spec: ModelSpec, layout: FieldLayout) -> list[Op]:
    """models/multitask.py MultiTask: shared trunk + per-head towers."""
    ops, cur = _trunk("input", spec)
    tower_act = spec.activations[-1]
    head_bufs = []
    for h in range(spec.num_heads):
        ops.append(_dense(cur, f"tower{h}", f"tower_{h}/Dense_0", tower_act))
        ops.append(_dense(f"tower{h}", f"logit{h}",
                          f"shifu_output_{h}/Dense_0", None))
        head_bufs.append(f"logit{h}")
    if len(head_bufs) > 1:
        ops.append({"op": "concat", "srcs": head_bufs, "out": "logits"})
    else:
        ops.append({"op": "activation", "src": head_bufs[0], "out": "logits",
                    "fn": "linear"})
    ops.append(_sigmoid("logits"))
    return ops


def _moe_mlp_program(spec: ModelSpec, layout: FieldLayout) -> list[Op]:
    """models/moe.py MoEMLP: softmax gate + stacked expert trunks +
    gate-weighted combine + shared head."""
    ops: list[Op] = [_dense("input", "gate_logits", "gate/Dense_0", None)]
    ops.append({"op": "activation", "src": "gate_logits", "out": "gate",
                "fn": "softmax"})
    cur = "input"
    for i, act in enumerate(spec.activations):
        ops.append({"op": "expert_dense", "src": cur, "out": f"eh{i}",
                    "kernel": f"experts/kernel{i}",
                    "bias": f"experts/bias{i}", "activation": act})
        cur = f"eh{i}"
    ops.append({"op": "moe_combine", "srcs": [cur, "gate"], "out": "combined"})
    ops.append(_dense("combined", "logits", "shifu_output_0/Dense_0", None))
    ops.append(_sigmoid("logits"))
    return ops


def _ft_transformer_program(spec: ModelSpec, layout: FieldLayout) -> list[Op]:
    """models/ft_transformer.py FTTransformer: tokenize -> CLS -> blocks ->
    final LN -> head."""
    ops: list[Op] = []
    token_bufs = []
    if layout.num_numeric:
        ops.append(_gather_numeric(layout))
        ops.append(_numeric("numeric", "num_tokens", "numeric_tokenizer"))
        token_bufs.append("num_tokens")
    if layout.num_categorical:
        ops.append(_embed(layout, "cat_tokenizer/embedding", "cat_tokens"))
        token_bufs.append("cat_tokens")
    if len(token_bufs) > 1:
        ops.append({"op": "concat", "srcs": token_bufs, "out": "tokens"})
        tokens = "tokens"
    else:
        tokens = token_bufs[0]
    ops.append({"op": "cls_prepend", "src": tokens, "out": "x0",
                "token": "cls_token"})
    cur = "x0"
    for i in range(spec.num_layers):
        b = f"block_{i}"
        nxt = f"x{i + 1}"
        ops.append({
            "op": "transformer_block", "src": cur, "out": nxt,
            "num_heads": spec.num_attention_heads,
            "ln_attn_scale": f"{b}/ln_attn/scale",
            "ln_attn_bias": f"{b}/ln_attn/bias",
            "qkv_kernel": f"{b}/qkv/kernel", "qkv_bias": f"{b}/qkv/bias",
            "proj_kernel": f"{b}/proj/kernel", "proj_bias": f"{b}/proj/bias",
            "ln_mlp_scale": f"{b}/ln_mlp/scale",
            "ln_mlp_bias": f"{b}/ln_mlp/bias",
            "mlp_in_kernel": f"{b}/mlp_in/kernel",
            "mlp_in_bias": f"{b}/mlp_in/bias",
            "mlp_out_kernel": f"{b}/mlp_out/kernel",
            "mlp_out_bias": f"{b}/mlp_out/bias",
        })
        cur = nxt
    ops.append({"op": "select_token", "src": cur, "out": "cls_out", "index": 0})
    ops.append({"op": "layernorm", "src": "cls_out", "out": "cls_norm",
                "scale": "ln_final/scale", "bias": "ln_final/bias"})
    ops.append(_dense("cls_norm", "logits", "shifu_output_0/Dense_0", None))
    ops.append(_sigmoid("logits"))
    return ops


_BUILDERS = {
    "mlp": _mlp_program,
    "wide_deep": _wide_deep_program,
    "deepfm": _deepfm_program,
    "multitask": _multitask_program,
    "ft_transformer": _ft_transformer_program,
    "moe_mlp": _moe_mlp_program,
}


def build_program_v2(spec: ModelSpec,
                     schema: Optional[DataSchema]) -> Optional[list[Op]]:
    """Lower a ladder model to the v2 op list; None for unknown types.

    `schema` may be None only for models whose program is layout-free (the
    plain MLP); layout-dependent models return None without a schema.
    """
    builder = _BUILDERS.get(spec.model_type)
    if builder is None:
        return None
    if schema is None:
        if spec.model_type not in ("mlp", "moe_mlp"):
            return None  # layout-dependent models need the schema
        layout = FieldLayout((), (), ())
    else:
        layout = field_layout(schema)
    return builder(spec, layout)
