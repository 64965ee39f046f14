"""A configuration's model module, found by name.

Each configuration file names, under its ``"model"`` key, the module that
knows its layers: ``portbench/models/<model>.py`` under a root (the
checkout's own, or one that a test points elsewhere).  The module owns
what differs between architectures: the program's config, the weight
tree and its draw, the plain reference's layer loop, the layout of the
routing records and the non-expert terms of the work counts.  What every
MoE model shares stays in ``portbench/lib/``.  A file without the key, or
a key that names no module, is an error that names the file.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re
from types import ModuleType
from typing import Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]
MODELS = pathlib.Path("portbench") / "models"

# Each module file runs once in a process, as an import would, however
# often a configuration's module is asked for.
_loaded: Dict[pathlib.Path, ModuleType] = {}


def model_module(cfg: dict, where: Optional[str] = None,
                 root: pathlib.Path = ROOT) -> ModuleType:
    """The module that ``cfg["model"]`` names under ``root``; ``where``
    (the configuration's file) is named in the errors."""
    where = where or f"configuration {cfg.get('name', '?')!r}"
    name = cfg.get("model")
    if name is None:
        raise KeyError(f"{where}: no \"model\" key; it names the module "
                       f"under {MODELS}/ that models the layers")
    if not isinstance(name, str) or not re.fullmatch(r"\w+", name):
        raise ValueError(f"{where}: \"model\" must be a module's name, "
                         f"not {name!r}")
    path = (pathlib.Path(root) / MODELS / f"{name}.py").resolve()
    if path not in _loaded:
        if not path.is_file():
            raise FileNotFoundError(f"{where}: \"model\": {name!r} names "
                                    f"no module ({path} does not exist)")
        spec = importlib.util.spec_from_file_location(
            f"portbench_model_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
