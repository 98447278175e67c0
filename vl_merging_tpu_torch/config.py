"""Experiment configs, shared with the JAX package.

``vl_merging_tpu/config.py`` is pure Python: it imports only ``ast``,
``copy`` and ``typing``.  The port executes that one file as a module of
its own, so both packages build their configs from the same code and
cannot drift, while the JAX package itself (``vl_merging_tpu`` and its
subpackages, which import jax) is never imported.
"""

import importlib.util
from pathlib import Path

_SOURCE = Path(__file__).resolve().parent.parent / "vl_merging_tpu" / "config.py"
_spec = importlib.util.spec_from_file_location(f"{__name__}._shared", _SOURCE)
_shared = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_shared)

build_config = _shared.build_config

__all__ = ["build_config"]
