"""Object broadcast and allgather — the port of
``horovod_tpu/functions.py``'s ``broadcast_object``/``allgather_object``.

An object is pickled and travels through the controller's store (the
c10d store of ``init()``), not through a collective, so it can be of any
size and type the store carries. Keys are unique per name and call (a
per-name sequence: every process that uses a name must make the same
calls under it) and deleted once every reader has read them. In a world
of one the object is returned as it is.
"""

from __future__ import annotations

import base64
import itertools
import pickle
import threading
from typing import Any, List

import torch

from .common import basics
from .common.exceptions import HorovodInternalError

_seq_lock = threading.Lock()
_seq: dict = {}


def _next_seq(name: str) -> int:
    with _seq_lock:
        return next(_seq.setdefault(name, itertools.count()))


def _dumps(obj: Any) -> str:
    return base64.b64encode(pickle.dumps(
        obj, protocol=pickle.HIGHEST_PROTOCOL)).decode()


def _read(transport, key: str, timeout_s: float) -> Any:
    raw = transport.get(key, timeout_s)
    if raw is None:
        raise HorovodInternalError(f"no value under {key} within "
                                   f"{timeout_s}s")
    return pickle.loads(base64.b64decode(raw))


def broadcast_object(obj: Any, root_rank: int = 0, name: str = "obj"
                     ) -> Any:
    """``root_rank``'s ``obj`` on every process."""
    ctl = basics.context().controller
    if ctl is None:
        return obj
    key = f"{ctl.ns}/bcast/{name}/{_next_seq(name)}"
    if ctl.rank == root_rank:
        ctl.transport.set(key, _dumps(obj))
        return obj
    out = _read(ctl.transport, key, ctl.timeout_s)
    ctl.transport.read_by(f"{key}/read", ctl.size - 1, [key])
    return out


def allgather_object(obj: Any, name: str = "obj") -> List[Any]:
    """One object per process, in rank order, on every process."""
    ctl = basics.context().controller
    if ctl is None:
        return [obj]
    base = f"{ctl.ns}/ag/{name}/{_next_seq(name)}"
    ctl.transport.set(f"{base}/{ctl.rank}", _dumps(obj))
    keys = [f"{base}/{r}" for r in range(ctl.size)]
    out = [_read(ctl.transport, key, ctl.timeout_s) for key in keys]
    ctl.transport.read_by(f"{base}/read", ctl.size, keys)
    return out


def broadcast_variables(tree: Any, root_rank: int = 0) -> Any:
    """``tree`` (nested dicts, lists and tuples of tensors) with every
    tensor replaced by a new one of the same shape holding
    ``root_rank``'s value (reference ``tensorflow/functions.py``
    ``broadcast_variables``; the in-place form for parameters is
    ``broadcast_parameters``). Other leaves pass through."""
    from .common import tree as tree_lib
    from .ops import collectives as C

    def one(v):
        if not isinstance(v, torch.Tensor):
            return v
        return C.broadcast_(v.detach().clone(), root_rank)

    return tree_lib.map_tree(one, tree)
