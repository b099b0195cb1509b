"""The port's runtime: the scoring daemon and its engines (`serve`), the
wire server (`serve_wire`), the loadtest, the fleet and its router, and
the native C++ scorer (`native_scorer`), whose entry points the JVM
binding's build uses are re-exported here as the JAX package's
`shifu_tpu.runtime` exports them: `build_library()` compiles the scorer
and returns the shared library's path, `pack_native(export_dir)` writes
an artifact's `model.bin`, `NativeScorer` binds the library through
ctypes.  They load on first use, so importing a submodule stays cheap.
"""

from __future__ import annotations

_NATIVE = ("MODEL_BIN", "NativeScorer", "build_library", "pack_native")

__all__ = list(_NATIVE)


def __getattr__(name: str):
    if name in _NATIVE:
        from . import native_scorer
        return getattr(native_scorer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
