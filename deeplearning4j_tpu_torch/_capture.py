"""The hooks a step profile reads: the kernel wrappers' analytic costs and
the mesh's collectives.

``telemetry.xprofile`` profiles a step by running it once under a capture
(a ``TorchDispatchMode``, which autograd carries into its own threads).
While one is active, ``priced`` wrappers report their kernel's analytic
cost into it and hide the ops they run inside from its op counter, so a
step counts the same work whether a wrapper launched its CUDA kernel (which
the dispatcher never sees) or ran its plain version on the CPU; and
``collective`` records each collective the mesh makes. With no capture
active each hook is one global read.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

# the capture profiling a step in this process, or None
_active = None


class KernelCost(NamedTuple):
    """What one launch of a kernel does: FLOPs, transcendental operations,
    and the bytes it must move (each input read once, each output written
    once)."""

    flops: float
    transcendentals: float
    bytes: float


def set_active(capture) -> None:
    global _active
    _active = capture


def active():
    """The active capture when this thread runs under it (its dispatch
    mode is on this thread's mode stack, autograd's threads included),
    else None."""
    cap = _active
    if cap is None or not cap.on_this_thread():
        return None
    return cap


def priced(name: str, cost: Callable[..., KernelCost]):
    """Decorate kernel wrapper ``name``: under an active capture, each
    call adds ``cost(*args, **kwargs)`` to it and the ops the call runs
    (its plain version on the CPU, allocations on the card) are not
    counted as ops of the step."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _active is None:
                return fn(*args, **kwargs)
            cap = active()
            if cap is None:
                return fn(*args, **kwargs)
            cap.add_kernel(name, cost(*args, **kwargs))
            cap.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                cap.depth -= 1

        inner.cost = cost
        return inner

    return wrap


def collective(kind: str, payload_bytes: int, group_size: int) -> None:
    """Record one collective of the port's ``kind`` (``parallel.mesh``'s
    names) moving ``payload_bytes`` over a group of ``group_size`` ranks
    into the active capture, if any."""
    if _active is None:
        return
    cap = active()
    if cap is not None:
        cap.add_collective(kind, int(payload_bytes), int(group_size))
