"""The port's runtime: the scoring daemon and its engines (`serve`:
`ScoringDaemon`, `ModelRegistry`, `load_engine`, `serve_forever`), the
wire server (`serve_wire`), the loadtest, the fleet and its router, and
the native C++ scorer (`native_scorer`), whose entry points the JVM
binding's build uses are re-exported here as the JAX package's
`shifu_tpu.runtime` exports them: `build_library()` compiles the scorer
and returns the shared library's path, `pack_native(export_dir)` writes
an artifact's `model.bin`, `NativeScorer` binds the library through
ctypes.  They load on first use, so importing a submodule stays cheap.
"""

from __future__ import annotations

from .._lazy import exports

__getattr__, __all__ = exports(__name__, {
    "native_scorer": ("MODEL_BIN", "NativeScorer", "build_library",
                      "pack_native"),
    "serve": ("ModelRegistry", "ScoringDaemon", "ServeOverload",
              "load_engine", "serve_forever"),
})
