"""Base-call contract enforcement: an override of a method marked
``@enforce_base_call`` must call the base implementation, else a
``TypeError`` is raised after the override returns.

The port's copy of ``vietnamese_qa_system_tpu/utils/contracts.py``: the
calls seen are kept on a ``ContextVar`` stack, so the check holds under
threads and nested calls.
"""

from __future__ import annotations

import contextvars
import functools

_call_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar("base_call_stack", default=())


def enforce_base_call(method):
    """Mark a base-class method as must-be-called-by-overrides."""
    marker = (method.__qualname__,)

    @functools.wraps(method)
    def base_wrapper(*args, **kwargs):
        _call_stack.set(_call_stack.get() + marker)
        return method(*args, **kwargs)

    base_wrapper.__base_call_marker__ = method.__name__
    return base_wrapper


class BaseCallEnforcedMeta(type):
    """Wrap subclass overrides of @enforce_base_call methods so that
    skipping super() raises a TypeError after the override returns."""

    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        for attr, value in ns.items():
            if not callable(value):
                continue
            for base in cls.__mro__[1:]:
                base_fn = base.__dict__.get(attr)
                if base_fn is not None and hasattr(base_fn, "__base_call_marker__"):
                    setattr(cls, attr, mcs._checked(value, base_fn))
                    break
        return cls

    @staticmethod
    def _checked(override, base_fn):
        marker = base_fn.__qualname__

        @functools.wraps(override)
        def wrapper(*args, **kwargs):
            token = _call_stack.set(())
            try:
                out = override(*args, **kwargs)
                if marker not in _call_stack.get():
                    raise TypeError(f"{override.__qualname__} overrides {marker} but never calls "
                                    f"super().{base_fn.__base_call_marker__}()")
                return out
            finally:
                _call_stack.reset(token)

        return wrapper
