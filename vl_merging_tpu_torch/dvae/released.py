"""Reading OpenAI's released dVAE pickles (``encoder.pkl``,
``decoder.pkl``) without the ``dall_e`` package.

The released files are whole ``dall_e.encoder.Encoder`` /
``dall_e.decoder.Decoder`` modules pickled by ``torch.save``.  This module
is the ``pickle_module`` that ``torch.load`` takes for them: its
``Unpickler`` resolves every ``dall_e.*`` class to an inert ``Stub``
that keeps the state the pickle hands to ``__setstate__`` (the module's
``__dict__``: ``_parameters``, ``_modules``, …); every other class
resolves as usual (torch's rebuild functions, ``collections.OrderedDict``,
``torch.device``, the ``torch.nn`` containers).  ``module_params`` reads
the parameter names from the stubs' ``_parameters`` and ``_modules`` in
``named_parameters()`` order.
"""

from __future__ import annotations

import pickle
import sys
from typing import Dict

import torch


class Stub:
    """A stand-in for a ``dall_e`` class: it runs no code of its own and
    keeps its pickled state as ``state``."""

    def __setstate__(self, state) -> None:
        self.__dict__["state"] = state


_STUBS: Dict[tuple, type] = {}


def _stub(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STUBS:
        _STUBS[key] = type(name, (Stub,), {"__module__": module,
                                           "__qualname__": name})
    return _STUBS[key]


class Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "dall_e" or module.startswith("dall_e."):
            return _stub(module, name)
        return super().find_class(module, name)


def load(file, **kwargs):
    return Unpickler(file, **kwargs).load()


def _state(obj):
    """A pickled module's ``__dict__``, or None for anything else."""
    state = vars(obj).get("state") if isinstance(obj, Stub) else getattr(
        obj, "__dict__", None)
    if isinstance(state, dict) and isinstance(
            state.get("_parameters"), dict) and isinstance(
            state.get("_modules"), dict):
        return state
    return None


def module_params(root, path: str) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} of a pickled ``dall_e`` module, in the order and
    with the names of ``named_parameters()`` (a module or a parameter
    reached twice counted once); ``ValueError`` naming ``path`` for any
    other object."""
    if not isinstance(root, Stub):
        raise ValueError(f"{path}: holds a {type(root).__module__}."
                         f"{type(root).__qualname__}, not a pickled dall_e "
                         f"module")
    out: Dict[str, torch.Tensor] = {}
    seen = set()

    def walk(obj, prefix: str) -> None:
        if id(obj) in seen:
            return
        seen.add(id(obj))
        state = _state(obj)
        if state is None:
            raise ValueError(f"{path}: {prefix or 'the root'} is a "
                             f"{type(obj).__qualname__} without a module's "
                             f"_parameters and _modules")
        for name, p in state["_parameters"].items():
            if p is None or id(p) in seen:
                continue
            if not isinstance(p, torch.Tensor):
                raise ValueError(f"{path}: parameter {prefix}{name} is a "
                                 f"{type(p).__qualname__}")
            seen.add(id(p))
            out[prefix + name] = p.detach().float()
        for name, child in state["_modules"].items():
            if child is not None:
                walk(child, f"{prefix}{name}.")

    walk(root, "")
    return out


def load_module_params(path: str) -> Dict[str, torch.Tensor]:
    """``module_params`` of the pickled module in ``path``, unpickled on the
    CPU by this module's ``Unpickler``."""
    try:
        root = torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=sys.modules[__name__])
    except Exception as e:
        raise ValueError(f"{path}: not a pickled module that torch.load "
                         f"reads ({type(e).__name__}: {e})") from e
    return module_params(root, path)
