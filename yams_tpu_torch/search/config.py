"""SearchEngineConfig, the reference's own dataclass (and VectorIndexConfig,
re-exported from yams_tpu.core.config, which imports no jax).

`import yams_tpu.search.config` would run `yams_tpu/search/__init__.py`,
which imports the JAX engine. The file itself imports only dataclasses, so
it is loaded here by path, as a module of this package, and its class is
re-exported unchanged: both engines read one definition of every default.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

from yams_tpu.core.config import VectorIndexConfig

_NAME = __name__ + "._reference"


def _load_reference():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.find_spec("yams_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise ImportError("yams_tpu (the reference package) is not importable")
    path = pathlib.Path(spec.submodule_search_locations[0]) / "search" / "config.py"
    mod_spec = importlib.util.spec_from_file_location(_NAME, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[_NAME] = module  # dataclasses resolves the module by name
    mod_spec.loader.exec_module(module)
    return module


SearchEngineConfig = _load_reference().SearchEngineConfig

__all__ = ["SearchEngineConfig", "VectorIndexConfig"]
