"""Parameter schema: shapes, logical axes and initializers in one place.

A model's parameters are a nested dict/list tree whose leaves are
``ParamSpec``s, with the same key paths as the JAX package's schema, so
a tree exported from JAX (as numpy arrays) loads leaf for leaf through
:func:`from_numpy`.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim
    init: str = "normal"                 # normal|zeros|ones|ssm_A|ssm_dt
    scale: float = 0.02
    dtype: Optional[str] = None          # overrides the model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over a dict/list/tuple tree; ``path`` is a
    tuple of dict keys and sequence indices (the JAX key-path order)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(path, tree)


def tree_map(fn, tree):
    return tree_map_with_path(lambda _p, leaf: fn(leaf), tree)


def tree_flatten_with_path(tree, path=()):
    """``[(path, leaf)]`` in the JAX package's leaf order: dict keys
    sorted, sequences in order, None an empty subtree."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def tree_leaves(tree):
    return [leaf for _p, leaf in tree_flatten_with_path(tree)]


def tree_unflatten_like(tree, leaves):
    """``tree``'s structure holding ``leaves``, given in the order of
    :func:`tree_leaves`."""
    at = {p: leaf for (p, _), leaf in zip(tree_flatten_with_path(tree),
                                          leaves, strict=True)}
    return tree_map_with_path(lambda p, _leaf: at[p], tree)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("ssm_A", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_A" else (1e-3, 1e-1)
        u = torch.empty(spec.shape, dtype=torch.float32, device=device)
        u.uniform_(lo, hi, generator=gen)
        if spec.init == "ssm_A":
            # A_log: log of uniform [1, 16] per head (mamba2's default)
            return torch.log(u).to(dtype)
        # dt bias: inverse softplus of uniform [1e-3, 1e-1]
        return (u + torch.log(-torch.expm1(-u))).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    # truncated normal on [-2, 2] (unit std before scaling), f32, scaled
    # in place (one f32 copy of the leaf: internvl2_26b's (48, 6144, 16384)
    # MLP leaves are 19.3 GB each in f32), then cast
    w = torch.empty(spec.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(spec.scale).to(dtype)


def init_params(schema, seed: int, default_dtype: str = "float32",
                device="cpu"):
    """Deterministic init: one ``torch.Generator`` per leaf, seeded from
    the model seed and ``zlib.crc32`` of the leaf's key path — never
    builtin ``hash()``, which is salted per process.  The numbers differ
    from JAX's (another generator); parity tests load JAX's weights
    through :func:`from_numpy` instead."""
    device = torch.device(device)

    def leaf(path, spec):
        tag = zlib.crc32(_path_str(path).encode()) & 0x7FFFFFFF
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) << 31) | tag)
        return _init_leaf(spec, gen, DTYPES[spec.dtype or default_dtype],
                          device)

    return tree_map_with_path(leaf, schema)


def stacked(schema, n: int, axis_name: Optional[str] = None):
    """Prepend a stacked-layers dim of size n to every spec in the subtree."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes,
                                        s.init, s.scale, s.dtype), schema)


def abstract_params(schema, default_dtype: str = "float32"):
    """Meta tensors of the schema's shapes and dtypes (no storage): the
    dry run's stand-ins for ``jax.ShapeDtypeStruct``."""
    return tree_map(lambda s: torch.empty(
        s.shape, dtype=DTYPES[s.dtype or default_dtype], device="meta"),
        schema)


def logical_axes(schema):
    """The logical axis names of every leaf: a tree of tuples."""
    return tree_map(lambda s: s.axes, schema)


def count_params(schema) -> int:
    return int(sum(int(np.prod(s.shape)) for s in tree_leaves(schema)))


def from_numpy(tree, device="cpu", dtype=None):
    """A tree of numpy arrays (e.g. the JAX package's params or stacked
    sp tree, exported with ``np.asarray``) -> the same tree of torch
    tensors on ``device``.  ``dtype`` casts floating leaves; None keeps
    each leaf's own dtype.  Integer leaves are never cast."""
    device = torch.device(device)
    want = DTYPES[dtype] if dtype is not None else None

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes: no torch view
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))     # a writable copy
        if want is not None and t.is_floating_point():
            t = t.to(want)
        return t.to(device)

    return tree_map(leaf, tree)


def to_numpy(tree):
    """Inverse of :func:`from_numpy` (bf16 leaves come back as float32).
    An export to the host (artifacts, checkpoints, tests): no step runs
    it, so its host reads are off every captured path."""
    def leaf(t):
        t = t.detach().cpu()  # repro: ignore[host-sync-in-step] -- host export
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()  # repro: ignore[host-sync-in-step] -- host export
    return tree_map(leaf, tree)
