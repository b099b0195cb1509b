"""The model ladder (port of shifu_tpu/models/): MLP, Wide&Deep, DeepFM,
multi-task heads, MoE and the FT-Transformer, built by type name through
`build_model`; `register` adds a type.  The names load on first use."""

from .._lazy import exports

__getattr__, __all__ = exports(__name__, {
    "base": ("MLPTrunk", "ScoringHead", "ShifuDense"),
    "deepfm": ("DeepFM",),
    "embedding": ("CategoricalEmbed", "FieldLayout", "NumericEmbed",
                  "field_layout", "split_features"),
    "ft_transformer": ("FTTransformer",),
    "mlp": ("ShifuMLP",),
    "multitask": ("MultiTask",),
    "registry": ("build_model", "register"),
    "wide_deep": ("WideDeep",),
})
