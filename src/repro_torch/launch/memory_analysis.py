"""Per-device peak memory of one step, counted from the storages that
the ops each rank dispatches create and free (the port's counterpart of
``compiled.memory_analysis()`` in the JAX package's dry run, which reads
XLA's buffer assignment; eager torch has none).

:class:`PeakCounter` is a ``TorchDispatchMode`` that, as
``cost_analysis.CostCounter`` does, lets DTensor run first (it returns
``NotImplemented`` for DTensor operands) and so sees the aten ops on this
rank's **local shards**, the redistributions' collectives included.  It
keeps the bytes of the storages alive on one device:

* the arguments' local storages are live from the start;
* an op output on a storage not seen before adds that storage's bytes;
  a view, an alias or an in-place write lands on a storage already seen
  and adds nothing;
* a storage's bytes leave when the last tensor on it dies (a weak
  reference to the storage, whose callback runs when torch frees it), so
  the count follows what is alive as the caching allocator does: the
  tensors autograd saves until the backward frees them, a checkpointed
  block's recomputation in the backward, accumulated grads, the
  optimizer's temporaries;
* a storage that exists before the step and is not an argument (a
  tensor a caller holds) is taken as already resident: it counts as
  nothing, as the card's allocator had it before the step began.

The accounting reads shapes, dtypes and storages only, so meta tensors
and real ones give the same numbers.  It sees what is dispatched: an
op's internal workspace (a sort's or a cuBLAS product's scratch) is
freed inside the op and never reaches it, and the caching allocator's
512-byte granules are kept apart (``rounded_peak_bytes``).  DTensor's
sharding propagation runs ops on fake tensors, which allocate nothing:
they pass uncounted.  An op it cannot account for (a higher-order op, an
output without a storage, a storage resized in place) raises.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the CUDA caching allocator's block granule: every allocation is rounded
# up to a multiple of it
ALLOC_ROUND = 512


def rounded(nbytes: int) -> int:
    """``nbytes`` as the caching allocator reserves them (an empty
    storage allocates nothing)."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree):
    from torch.distributed.tensor import DTensor
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            yield t._local_tensor
        elif isinstance(t, torch.Tensor):
            yield t


def op_name(func) -> str:
    """``func``'s namespace and name without its overload
    (``aten.mm``)."""
    return f"{func.namespace}.{func._overloadpacket.__name__}"


class PeakCounter(TorchDispatchMode):
    """Live and peak bytes on one device of the ops run under it (per
    rank).  ``args``: the step's arguments (a tree of tensors or
    DTensors, all on the device counted), live from the start.

    After the step: ``peak_bytes`` (arguments included), ``temp_bytes``
    (the peak above the arguments), ``peak_op`` (the op whose outputs
    made the peak), ``rounded_peak_bytes`` (the same count with every
    storage rounded to :data:`ALLOC_ROUND`)."""

    def __init__(self, args):
        super().__init__()
        leaves = list(_tensors(args))
        devices = {t.device for t in leaves}
        if len(devices) != 1:
            raise ValueError(f"PeakCounter counts one device; the "
                             f"arguments give {sorted(map(str, devices))}")
        self.device = devices.pop()
        self._lock = threading.RLock()
        # id(storage) -> (weak reference, bytes counted, rounded bytes)
        self._storages: Dict[int, Tuple[weakref.ref, int, int]] = {}
        self.live = self.live_rounded = 0
        for t in leaves:
            st = t.untyped_storage()
            if id(st) not in self._storages:       # views share one
                self._add(st, counted=True)
        self.argument_bytes = self.live
        self.peak_bytes = self.live
        self.rounded_peak_bytes = self.live_rounded
        self.peak_op: Optional[str] = None

    def _add(self, st, counted: bool) -> None:
        n = st.nbytes() if counted else 0
        r = rounded(n)
        key = id(st)

        def release(_, key=key, n=n, r=r):
            with self._lock:
                self._storages.pop(key, None)
                self.live -= n
                self.live_rounded -= r
        self._storages[key] = (weakref.ref(st, release), n, r)
        self.live += n
        self.live_rounded += r

    def _storage(self, t: torch.Tensor, name: str):
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError) as e:
            raise NotImplementedError(
                f"PeakCounter cannot account for {name}: its "
                f"{type(t).__name__} output has no storage ({e})") from e

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor first: then its local ops
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            raise NotImplementedError(
                f"PeakCounter cannot account for the higher-order op "
                f"{func}")
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)    # shape inference: no storage
        name = op_name(func)
        with self._lock:
            for t in _tensors((args, kwargs)):
                if t.device == self.device:
                    st = self._storage(t, name)
                    if id(st) not in self._storages:
                        self._add(st, counted=False)   # already resident
        out = func(*args, **kwargs)
        with self._lock:
            for t in _tensors(out):
                if t.device != self.device:
                    continue
                st = self._storage(t, name)
                seen = self._storages.get(id(st))
                if seen is None:
                    self._add(st, counted=True)
                elif seen[1] and st.nbytes() != seen[1]:
                    raise NotImplementedError(
                        f"PeakCounter cannot account for {name}: it "
                        f"resized a storage from {seen[1]} to "
                        f"{st.nbytes()} bytes")
            if self.live > self.peak_bytes:
                self.peak_bytes, self.peak_op = self.live, name
            self.rounded_peak_bytes = max(self.rounded_peak_bytes,
                                          self.live_rounded)
        return out

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def summary(self) -> dict:
        return {"peak_bytes": self.peak_bytes,
                "temp_bytes": self.temp_bytes,
                "argument_bytes": self.argument_bytes,
                "rounded_peak_bytes": self.rounded_peak_bytes,
                "peak_op": self.peak_op}
