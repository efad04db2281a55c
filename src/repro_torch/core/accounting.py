"""Hooks through which the op counter (`launch.hlo_analysis`) sees work that the
aten ops it records do not show as they are.

Two kinds:

  * `kernel_call`: a hand-written kernel is a ctypes call on the card and a
    chain of plain torch ops on the CPU.  Under the counter both count as
    the kernel's own work (one op, its FLOPs and bytes), whichever runs.
  * `repeat(n)`: the ops inside count n times.  Meta tensors carry shapes
    alone, so where a loop's iterations all dispatch the same ops (the
    flash attention's block pairs), the meta path runs one iteration
    under `repeat` for all of them (`loop`).

Without a counter both cost nothing.  The counter is process-wide, not
per thread or context: the autograd engine runs a card's backward on a
thread of its own, and the counter must see that work as well.
"""

from __future__ import annotations

import contextlib
from fractions import Fraction

_counter = None  # the active launch.hlo_analysis counter, or None


def set_counter(counter) -> None:
    """Make `counter` the one the hooks report to (None: no counter)."""
    global _counter
    _counter = counter


def kernel_call(name: str, impl, *args, **kw):
    """impl(*args, **kw), reported to the counter as one call of kernel `name`."""
    c = _counter
    if c is None:
        return impl(*args, **kw)
    return c.kernel_call(name, impl, args, kw)


_NULL = contextlib.nullcontext()


def repeat(n: int | Fraction):
    """A context inside which the counter counts every op n times (nested: the
    product); nothing without a counter."""
    c = _counter
    if c is None or n == 1:
        return _NULL
    return c.repeated(n)


def loop(items, short: bool, reps: int | Fraction | None = None):
    """`items` itself where not `short`; where `short`, an iterator over the first
    item alone, every op of its iteration counted `reps` times (len(items)
    by default).

    The items' iterations must dispatch the same ops.  Loops nest: an inner
    loop's reps multiply the outer one's, so a Fraction counts a ragged
    inner loop (reps = inner iterations in all / outer iterations).
    """
    if not short:
        return items
    return _first_for_all(list(items), reps)


def _first_for_all(items: list, reps):
    if not items:
        return
    with repeat(len(items) if reps is None else reps):
        yield items[0]
