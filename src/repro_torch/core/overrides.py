"""`overridable`: a compound op of the models that a pass over the model may take.

A function so marked runs its body, unless a pass has installed a taker
(`taking`): then the taker gets the call and the body (`take(body, args,
kwargs)`) and runs the body itself around whatever it does.  The taker is
per context, so it holds in a backward pass run inside the block too.
Without one a call costs a context-variable read.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

_TAKER: contextvars.ContextVar = contextvars.ContextVar("repro_torch_taker", default=None)


def overridable(fn):
    """fn, which an installed taker may run in its own way."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        take = _TAKER.get()
        if take is None:
            return fn(*args, **kwargs)
        return take(entry, fn, args, kwargs)
    return entry


@contextlib.contextmanager
def taking(take):
    """Make take(op, body, args, kwargs) the taker of every `overridable` call inside
    the block (op is the marked function, body its own); the previous taker comes
    back on exit."""
    token = _TAKER.set(take)
    try:
        yield
    finally:
        _TAKER.reset(token)
