"""The scoring artifact (port of shifu_tpu/export/): `save_artifact`, its
op-list program (`build_program`) and the scorers (`Scorer`, the numpy
interpreter; `load_scorer`).  The names load on first use, since they
import torch and the operator's views import this package."""

from .._lazy import exports

__getattr__, __all__ = exports(__name__, {
    "artifact": ("build_program", "save_artifact"),
    "scorer": ("Scorer", "load_scorer"),
})
