"""Re-exports on first use, for the port's subpackages: a package names
what it exports from each of its submodules, and a name's submodule is
imported when the name is first read, so that importing one submodule
(the operator's views do, without torch) imports none of the others."""

from __future__ import annotations

from importlib import import_module


def exports(package: str, names: dict[str, tuple[str, ...]]):
    """(`__getattr__`, `__all__`) for `package`, which re-exports every
    name of `names[submodule]` from `package.submodule`."""
    where = {name: mod for mod, group in names.items() for name in group}

    def __getattr__(name: str):
        mod = where.get(name)
        if mod is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        return getattr(import_module(f"{package}.{mod}"), name)

    return __getattr__, sorted(where)
