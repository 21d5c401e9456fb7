"""The registry body — ≙ ``mxnet_tpu/_ffi/function.py:18-86`` (upstream
``python/mxnet/_ffi/function.py`` and ``registry.py``).

A ``Function`` wraps any callable under a dotted name.  Arguments and
returns are Python values (tensors, numbers, strings, lists): the
dynamic typing of a PackedFunc without the C marshalling.  Unlike the
JAX package, ``get_global_func`` has no native registry to fall through
to: a name that is not registered here raises ``KeyError`` (or gives
None with ``allow_missing``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["Function", "register_func", "get_global_func",
           "list_global_func_names", "remove_global_func"]

_GLOBAL_FUNCS: Dict[str, "Function"] = {}


class Function:
    """≙ ``_ffi.function.Function``: a named packed callable."""

    __slots__ = ("name", "_fn", "is_global")

    def __init__(self, name: str, fn: Callable, is_global: bool = True):
        self.name = name
        self._fn = fn
        self.is_global = is_global

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def __repr__(self):
        return f"<ffi.Function {self.name}>"


def register_func(name_or_fn=None, f: Optional[Callable] = None,
                  override: bool = False):
    """≙ ``mxnet.register_func``: ``register_func("my.func", fn)``, the
    decorator ``@register_func("my.func")``, or bare ``@register_func``
    (the function's own name)."""
    if callable(name_or_fn) and f is None:
        return register_func(name_or_fn.__name__, name_or_fn)

    def do_register(fn):
        name = name_or_fn
        if name in _GLOBAL_FUNCS and not override:
            raise ValueError(
                f"global function {name!r} already registered "
                "(pass override=True to replace)")
        _GLOBAL_FUNCS[name] = Function(name, fn)
        return fn

    if f is not None:
        return do_register(f)     # both forms return the original fn
    return do_register


def get_global_func(name: str, allow_missing: bool = False):
    """≙ ``_ffi.get_global_func``: the ``Function``, or None with
    ``allow_missing``, else ``KeyError``."""
    fn = _GLOBAL_FUNCS.get(name)
    if fn is not None:
        return fn
    if allow_missing:
        return None
    raise KeyError(f"global function {name!r} is not registered")


def list_global_func_names():
    return sorted(_GLOBAL_FUNCS)


def remove_global_func(name: str):
    _GLOBAL_FUNCS.pop(name, None)


# ----------------------------------------------------------- built-ins
# ≙ the JAX module's runtime.* registrations (:88-107) that have a
# counterpart here.

def _features():
    """What this build can run: a card, and NVRTC (found on demand)."""
    import torch
    feats = {"CUDA": torch.cuda.is_available(), "TORCH": torch.__version__,
             "CUDA_VERSION": torch.version.cuda}
    try:
        from .. import _nvrtc
        feats["NVRTC"] = _nvrtc.info()["version"]
    except (OSError, RuntimeError):
        feats["NVRTC"] = None
    return feats


def _load_lib(path):
    from .. import library
    return library.load(path)


register_func("runtime.Features", _features, override=True)
register_func("runtime.LoadLib", _load_lib, override=True)
