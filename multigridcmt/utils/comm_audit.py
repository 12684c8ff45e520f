"""Communication audit: count collectives (and their bytes) in a jaxpr.

The machine-checkable stand-in for "halo exchange overlapped and not
duplicated" that needs no multi-device hardware: trace a sharded cycle,
walk the jaxpr (through pjit/shard_map/scan/cond sub-jaxprs), and count
every ``ppermute``/``all_gather`` equation plus the bytes its operands
move. Tests pin the counts to the structural minimum the runtime is
designed to emit (one near+far slab pair per sharded axis per exchange).

Counts are PER DEVICE per execution of the traced function: inside
``shard_map`` the traced shapes are shard-local, so a ppermute operand's
byte size is what one device sends.
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import numpy as np


def _sub_jaxprs(value: Any):
    """Yield every (Closed)Jaxpr nested inside an eqn param value."""
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _walk(jaxpr, counts: Dict[str, int], bytes_: Dict[str, int]):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("ppermute", "all_gather", "all_to_all", "psum",
                    "reduce_scatter"):
            counts[name] = counts.get(name, 0) + 1
            nb = 0
            for var in eqn.invars:
                aval = getattr(var, "aval", None)
                if aval is not None and hasattr(aval, "shape"):
                    nb += int(np.prod(aval.shape, dtype=np.int64)
                              * np.dtype(aval.dtype).itemsize)
            bytes_[name] = bytes_.get(name, 0) + nb
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                _walk(sub, counts, bytes_)


def audit(fn, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """Trace ``fn(*args, **kwargs)`` and return
    ``{"counts": {prim: n}, "bytes": {prim: total_operand_bytes}}``.

    ``fn`` may be jitted (the pjit call_jaxpr is walked through); args
    need only carry shape/dtype (jax.ShapeDtypeStruct works).
    """
    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    counts: Dict[str, int] = {}
    bytes_: Dict[str, int] = {}
    _walk(closed.jaxpr, counts, bytes_)
    return {"counts": counts, "bytes": bytes_}
