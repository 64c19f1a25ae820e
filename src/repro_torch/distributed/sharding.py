"""Logical-axis sharding rules with divisibility fallback, over a
``torch.distributed`` ``DeviceMesh`` (port of the JAX package's
``distributed/sharding.py``).

Params and activations carry *logical* axis names (``"embed"``,
``"heads"``, ``"mlp"``, ``"vocab"``, ``"experts"``, ``"batch"``,
``"kv_seq"``, ...).  A rules table maps each logical name to an ordered
list of candidate mesh-axis tuples; the first candidate whose size
divides the dim *and* whose mesh axes are not already taken by another
dim of the same array wins.  An empty-tuple candidate means "replicate",
the universal fallback: 8 q-heads cannot shard over model=16 and fall
back to replication while the MLP stays sharded.

Rule sets differ by mode:
  * TRAIN: FSDP-style, the ``embed`` (d_model) dim of weights also
    shards over ``data``, so params, grads and optimizer state scale
    with the pod.
  * SERVE: weights replicated over ``data``; the KV-cache sequence
    shards over spare axes (flash-decoding style).

A resolved spec is a tuple with one entry per dim: None, a mesh-axis
name, or a tuple of names (one dim over several mesh dims, major
first).  On a real mesh it becomes ``torch.distributed.tensor``
placements (:func:`placements`): a parameter's layout is
``distribute``, the reference's ``with_sharding_constraint`` is
:func:`constrain` (a ``redistribute``), and a computation that DTensor
has no sharding strategy for runs on each rank's local shards through
:func:`local_call`, with its inputs redistributed to the layout it
states.  Outside a :func:`sharding_context` nothing here acts: every
function returns its input, and the model runs on plain tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

Candidates = Tuple[Tuple[str, ...], ...]

# logical axis -> ordered candidates (each a tuple of mesh axes)
LOGICAL_RULES_TRAIN: Dict[str, Candidates] = {
    "batch":      (("pod", "data"), ("data",), ()),
    "vocab":      (("model",), ()),
    "heads":      (("model",), ()),
    "kv_heads":   (("model",), ()),
    "heads_flat": (("model",), ()),      # fused H*hd dim of wq/wo
    "kv_flat":    (("model",), ()),      # fused KV*hd dim of wk/wv
    "mlp":        (("model",), ()),
    "experts":    (("model",), ()),
    "expert_mlp": (("model",), ()),       # used when num_experts % model != 0
    "moe_capacity": (("model",), ()),     # dispatch token-slots (E indivisible)
    "grouped_in": (("model",), ()),       # per-shard channel groups (sparse)
    "embed":      (("data",), ()),        # FSDP dim in train mode
    "embed_act":  ((),),                  # activations' d_model: replicated
    "seq":        ((),),
    "kv_seq":     ((),),
    "ssm_heads":  (("model",), ()),
    "layers":     ((),),
}

LOGICAL_RULES_SERVE: Dict[str, Candidates] = {
    **LOGICAL_RULES_TRAIN,
    "embed":  ((),),                      # replicate weights across data
    # flash-decoding: shard the KV-cache sequence over whatever is spare
    "kv_seq": (("data", "model"), ("model",), ("data",), ()),
}


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or
    ``axis_names`` of any object with ``axis_names`` and ``devices``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size."""
    shape = mesh.shape if hasattr(mesh, "mesh_dim_names") \
        else mesh.devices.shape
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


@dataclasses.dataclass
class ShardingCtx:
    mesh: object
    rules: Dict[str, Candidates]
    overrides: Dict[str, Candidates] = dataclasses.field(default_factory=dict)

    def candidates(self, name: str) -> Candidates:
        if name in self.overrides:
            return self.overrides[name]
        return self.rules.get(name, ((),))


_STATE = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def sharding_context(mesh, rules=None, overrides=None):
    prev = current_ctx()
    rules = rules if rules is not None else LOGICAL_RULES_TRAIN
    _STATE.ctx = ShardingCtx(mesh, dict(rules), dict(overrides or {}))
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def _pick(name, dim: int, used: set, sizes: Dict[str, int],
          ctx: ShardingCtx) -> Tuple[str, ...]:
    """The first candidate of ``name`` whose axes are free in this array
    and whose size divides ``dim``; () replicates."""
    for cand in ctx.candidates(name):
        cand = tuple(a for a in cand if a in sizes)
        if any(a in used for a in cand):
            continue
        if cand and dim % math.prod(sizes[a] for a in cand):
            continue
        return cand
    return ()


def _entry(chosen: Tuple[str, ...]):
    if not chosen:
        return None
    return chosen if len(chosen) > 1 else chosen[0]


def mesh_axes_for(axes: Sequence[Optional[str]], shape: Sequence[int],
                  ctx: Optional[ShardingCtx] = None) -> tuple:
    """Resolve logical axes -> a spec (one entry per dim: None, a mesh
    axis, or a tuple of mesh axes), with the divisibility fallback and
    each mesh axis used at most once per array."""
    ctx = ctx or current_ctx()
    if ctx is None:
        return (None,) * len(shape)
    sizes = mesh_sizes(ctx.mesh)
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        chosen = _pick(name, dim, used, sizes, ctx) if name is not None \
            else ()
        used.update(chosen)
        out.append(_entry(chosen))
    return tuple(out)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> list:
    """DTensor placements of a resolved spec on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim d whose entry names it, else
    ``Replicate()``.  A multi-axis entry such as ``("pod", "data")``
    shards one dim over several mesh dims; the mesh lists its axes
    major first, as the rules do, so the default left-to-right nested
    split is the reference's major-to-minor one."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh, a resolved spec and its placements."""
    mesh: object
    spec: tuple
    placements: tuple


def named_sharding(axes, shape, ctx=None) -> Optional[NamedSharding]:
    ctx = ctx or current_ctx()
    if ctx is None:
        return None
    spec = mesh_axes_for(axes, shape, ctx)
    return NamedSharding(ctx.mesh, spec, tuple(placements(spec, ctx.mesh)))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over an axes tree and a tree of the same
    structure (tuples of names are leaves of the axes tree); None
    subtrees stay None."""
    if _is_axes(axes_tree):
        return fn(axes_tree, tree)
    if tree is None:
        return None
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], tree[k]) for k in tree}
    out = [_map_axes(fn, a, t) for a, t in zip(axes_tree, tree, strict=True)]
    return out if isinstance(tree, list) else tuple(out)


def axes_leaves(axes_tree, path=()):
    """``[(path, axes)]`` of an axes tree (tuples of names are leaves),
    in the port's leaf order (``models/params.tree_flatten_with_path``)."""
    if _is_axes(axes_tree):
        return [(path, axes_tree)]
    if isinstance(axes_tree, dict):
        return [kv for k in sorted(axes_tree)
                for kv in axes_leaves(axes_tree[k], path + (k,))]
    if axes_tree is None:
        return []
    return [kv for i, v in enumerate(axes_tree)
            for kv in axes_leaves(v, path + (i,))]


def param_shardings(schema_axes, abstract, ctx=None):
    """A logical-axes tree and a tree of tensors (meta or not) -> a tree
    of :class:`NamedSharding`."""
    ctx = ctx or current_ctx()
    return _map_axes(lambda axes, t: named_sharding(axes, t.shape, ctx),
                     schema_axes, abstract)


def replicate():
    """A ``Replicate()`` placement."""
    from torch.distributed.tensor import Replicate
    return Replicate()


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def place(t, axes, ctx=None):
    """One tensor placed on the context's mesh by its logical axes: a
    DTensor whose local shard is this rank's chunk of ``t``.  ``t`` must
    hold the same values on every rank (each rank keeps its own chunk;
    nothing is sent); a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor
    ctx = ctx or current_ctx()
    if ctx is None or not hasattr(ctx.mesh, "mesh_dim_names"):
        # no context, or a stand-in mesh that only resolves specs
        return t
    pl = placements(mesh_axes_for(axes, t.shape, ctx), ctx.mesh)
    if not isinstance(t, DTensor):
        t = _replicated(t, ctx.mesh)
    if tuple(t.placements) == tuple(pl):
        return t
    return t.redistribute(ctx.mesh, pl)


def distribute(tree, axes_tree, ctx=None):
    """Place every leaf of ``tree`` by its logical axes in ``axes_tree``
    (:func:`place`); the identity outside a context."""
    ctx = ctx or current_ctx()
    if ctx is None:
        return tree
    with torch.no_grad():
        return _map_axes(lambda axes, t: place(t, axes, ctx), axes_tree,
                         tree)


def constrain(x, *axes):
    """Redistribute ``x`` to the layout of its logical axes (the
    reference's ``with_sharding_constraint``); a no-op outside a
    context.  A plain tensor, the same on every rank, becomes a DTensor
    (each rank keeps its own chunk)."""
    ctx = current_ctx()
    if ctx is None:
        return x
    return place(x, axes, ctx)


def is_sharded(*tensors) -> bool:
    """Whether any of ``tensors`` is a DTensor.  Until something has
    imported ``torch.distributed.tensor`` none can be, so the unsharded
    path never pays its import (about a second) in a serving step."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor)
                                   for t in tensors)


def local(t):
    """A DTensor's local shard (a plain tensor as it is)."""
    return t.to_local() if is_sharded(t) else t


def full(t):
    """A DTensor gathered whole on every rank (a plain tensor as it is)."""
    return t.full_tensor() if is_sharded(t) else t


def dim_axes(t, d: int) -> Tuple[str, ...]:
    """The mesh axes DTensor ``t`` shards its dim ``d`` over (() for a
    plain tensor), major first."""
    if not is_sharded(t):
        return ()
    from torch.distributed.tensor import Shard
    names = axis_names(t.device_mesh)
    return tuple(names[i] for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim == d)


def unflatten(t, dim: int, sizes):
    """``t.unflatten(dim, sizes)``; a DTensor whose ``dim`` is sharded
    over more ranks than ``sizes[0]`` splits into is first made whole
    along it (GSPMD reshards there by itself)."""
    if is_sharded(t):
        dim = dim % t.dim()
        axes = dim_axes(t, dim)
        m = math.prod(mesh_sizes(t.device_mesh)[a] for a in axes)
        if sizes[0] % m:
            t = t.redistribute(t.device_mesh, [
                replicate() if p.is_shard(dim) else p for p in t.placements])
    return t.unflatten(dim, sizes)


class _Flatten(torch.autograd.Function):
    """A DTensor's dims ``dim .. dim+n-1`` merged; the backward splits
    the gradient with :func:`unflatten` (made whole where its layout
    cannot split)."""

    @staticmethod
    def forward(ctx, t, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return t.flatten(dim, dim + len(sizes) - 1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None, None


def flatten(t, dim: int, n: int):
    """``t.flatten(dim, dim + n - 1)``; on a DTensor the gradient splits
    back through :func:`unflatten`, since the layout a backward hands a
    merged dim (say, sharded over more ranks than heads) may not split
    as a view."""
    if not is_sharded(t) or not torch.is_grad_enabled() or \
            not t.requires_grad:
        return t.flatten(dim, dim + n - 1)
    return _Flatten.apply(t, dim, tuple(t.shape[dim:dim + n]))


def chunk_start(mesh, entry, size: int) -> int:
    """This rank's first index of a dim of ``size`` that a spec entry
    (a mesh axis or a tuple of them, major first) splits evenly."""
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for a in _axes_of(entry):
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return idx * (size // n)


def local_call(fn, args, in_axes, out_axes, *, rules=None,
               out_partial: Sequence[str] = (), inplace: Sequence[int] = ()):
    """``fn(*args)`` on each rank's local shards, the port's
    ``shard_map``: for a computation DTensor has no sharding strategy
    for (masks built with ``arange``, in-place cache writes, gathers by
    computed ids, the hand-written kernels).  Without a DTensor among
    ``args`` it is ``fn(*args)``.

    ``in_axes`` gives per arg a tuple of logical names, one per dim, or
    None for a non-tensor arg.  Names resolve *jointly*: the first
    array a name appears in resolves it by the rules (divisibility
    against that dim, its mesh axes free in that array); every later
    dim of that name takes the same mesh axes, so the local shards line
    up (a dim the rules would replicate is gathered).  ``out_axes``
    gives per output a tuple of names resolved the same way (one tuple
    for a single output); an output dim of a name no input resolved is
    replicated.  A plain tensor arg must hold the same values on every
    rank.

    ``rules`` adds candidates for names of this call only (say, the
    mesh axes a weight's output dim already has).  The mesh axes of the
    names in ``out_partial`` hold *partial sums* in every output (the
    work was split over them; the next redistribute adds them up).
    The args at ``inplace`` are written by ``fn``: they must need no
    redistribution, or the write would land in a copy.

    Gradients: an input replicated over a mesh dim that an output is
    sharded (or partial) over gets a partial gradient there (each rank
    saw its own shard of the work), as ``local_map``'s
    ``in_grad_placements`` would state it; so every input of a call
    with several outputs must feed each of them."""
    if not is_sharded(*args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    ctx = current_ctx() or ShardingCtx(mesh, dict(LOGICAL_RULES_SERVE))
    if rules:
        ctx = ShardingCtx(mesh, ctx.rules, {**ctx.overrides, **rules})
    sizes = mesh_sizes(mesh)
    resolved: Dict[str, Tuple[str, ...]] = {}

    def spec_of(axes, shape, output=False):
        used: set = set()
        out = []
        for name, dim in zip(axes, shape):
            if name is None or (output and name not in resolved):
                chosen = ()
            elif name in resolved:
                chosen = resolved[name]
                if any(a in used for a in chosen) or (
                        chosen and dim % math.prod(sizes[a] for a in chosen)):
                    raise ValueError(
                        f"local_call: {name!r} resolved to {chosen} cannot "
                        f"split a dim of {dim} here")
            else:
                chosen = _pick(name, dim, used, sizes, ctx)
                resolved[name] = chosen
            used.update(chosen)
            out.append(_entry(chosen))
        return tuple(out)

    in_pl = []
    for a, axes in zip(args, in_axes, strict=True):
        if isinstance(a, torch.Tensor):
            if axes is None:
                axes = (None,) * a.dim()
            in_pl.append(placements(spec_of(axes, a.shape), mesh))
        else:
            in_pl.append(None)
    single = _is_axes(out_axes)
    outs_axes = (out_axes,) if single else tuple(out_axes)
    out_specs = [spec_of(axes, (0,) * len(axes), True) if axes is not None
                 else None for axes in outs_axes]
    names = axis_names(mesh)
    partial = {names.index(a) for n in out_partial
               for a in resolved.get(n, ())}
    out_pl = [None if s is None else
              [Partial() if i in partial else p
               for i, p in enumerate(placements(s, mesh))]
              for s in out_specs]
    split = set(partial)          # mesh dims the outputs are split over
    for pl in out_pl:
        for i, p in enumerate(pl or ()):
            if isinstance(p, Shard):
                split.add(i)
    local_args = []
    for k, (a, pl) in enumerate(zip(args, in_pl)):
        if not isinstance(a, torch.Tensor):
            local_args.append(a)
            continue
        if not isinstance(a, DTensor):
            a = _replicated(a, mesh)
        if tuple(a.placements) != tuple(pl):
            if k in inplace:
                raise ValueError(
                    f"local_call: in-place arg {k} is laid out as "
                    f"{a.placements}, the call needs {pl}")
            a = a.redistribute(mesh, pl)
        grad_pl = [Partial() if (isinstance(p, Replicate) and i in split)
                   else p for i, p in enumerate(pl)]
        la = a.to_local(grad_placements=grad_pl)
        if la.requires_grad:
            # to_local's backward stamps the DTensor's own (contiguous)
            # strides on the grad: hand it a contiguous local grad
            la = _ContiguousGrad.apply(la)
        local_args.append(la)
    out = fn(*local_args)
    outs = (out,) if single else tuple(out)

    def wrap(o, pl):
        if not isinstance(o, torch.Tensor) or pl is None:
            return o
        shape = list(o.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    wrapped = tuple(wrap(o, pl) for o, pl in zip(outs, out_pl, strict=True))
    return wrapped[0] if single else wrapped


class _ContiguousGrad(torch.autograd.Function):
    """The identity, with its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
