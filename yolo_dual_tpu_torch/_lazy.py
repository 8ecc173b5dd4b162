"""Lazy public names of a subpackage (PEP 562): `from
yolo_dual_tpu_torch.engine import evaluate_segment` imports the submodule
that defines the name at first use, so importing a subpackage imports none of
its submodules, starts no build and closes no import cycle."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict):
    """(__getattr__, __all__) for `package`, whose `exports` map each
    public name to the submodule that defines it; a name that is itself the
    submodule's name is that submodule."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{exports[name]}")
        return module if name == exports[name] else getattr(module, name)

    return __getattr__, sorted(exports)
