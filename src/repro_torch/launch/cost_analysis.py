"""Per-device FLOPs, bytes and collective bytes of one step, counted from
the ops each rank dispatches (the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``; torch has no HLO to parse).

:class:`CostCounter` is a ``TorchDispatchMode`` that lets DTensor run
first (it returns ``NotImplemented`` for DTensor operands, as
``CommDebugMode`` does) and so sees the aten ops DTensor dispatches on
each rank's **local shards**, and the functional collectives its
redistributions run.  Counting at the DTensor level instead would give
global counts (``FlopCounterMode`` over DTensors reports the whole
product, not one device's share).

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, attention,
  convolutions) on the local shapes, forward and backward.
* Bytes: operand plus output bytes of every dispatched op that is not a
  view (and not an allocation or a collective).  Eager torch has no
  fusion, so every intermediate is counted as written and read again:
  an upper bound beside XLA's ``bytes accessed`` of fused HLO, where a
  fusion's internal traffic is free.
* Collectives: result bytes of each ``_c10d_functional`` op by kind
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the reference's per-device proxy for wire
  bytes (``roofline.wire_bytes`` doubles all-reduce).

Under the dry run's fake group every rank is rank 0, so the counts are
rank 0's; the rules give every rank a shard of the same size.  DTensor's
sharding propagation runs each op signature it has not cached on fake
tensors of the global shapes, and this mode sees those ops too: they
move nothing on any device and are not counted (else a cell's counts
would depend on what ran before it in the process).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")
# ops that allocate or relabel without moving data
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "wait_tensor", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset")


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of the local ops run
    under it (per rank)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.collective_counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor first: then its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in _COLLECTIVE_NS:
            kind = _KIND.get(name)
            if kind is not None:
                self.collectives[kind] += _nbytes(out)
                self.collective_counts[kind] += 1
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def summary(self) -> dict:
        return {"flops_per_device": float(self.flops),
                "bytes_per_device": float(self.bytes),
                "collectives": dict(self.collectives),
                "collective_counts": dict(self.collective_counts)}
