"""Top-k selection in the reference's order, shared by the plain kernel
versions (``ref``) and the gather backends of ``core/sparse_linear``."""
from __future__ import annotations

import torch


def topk_ids(scores, k: int):
    """Ids of the ``k`` largest ``scores``, largest first, the lower id
    first among equal values: ``jax.lax.top_k``'s order (``torch.topk``
    orders ties otherwise, which changes the kept set when k cuts through
    them)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]
