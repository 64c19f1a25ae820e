"""First-class sparsity execution policy (port of the JAX package's
``sparsity/policy.py``).

``SparsityPolicy`` is the *static* execution config for WiSparse: which
projection backend runs where (globally, per layer-role, or per depth
range), the static top-k bound ``k_max_frac`` and the channel-block
size.  The per-layer WiSparse parameters (``g``, ``alpha``, ``tau``,
``keep_frac``) stay in the ``sp`` tree of device tensors next to the
weights; the policy only decides how each projection consumes them.

Backends (dispatching in ``repro_torch.core.sparse_linear.project``):

    off          dense matmul (baseline)
    mask         per-token threshold mask, dense compute
    topk_shared  one weight-aware channel set per layer per call, shared
                 across the batch; gathered matmul
    topk_block   like topk_shared but whole ``block``-channel blocks
    pallas       the block-gather kernel path.  The name is kept from
                 the JAX package so policies and artifacts carry over; in
                 the port it routes to the Hopper CUDA kernels
                 (``repro_torch.kernels``).

The JAX policy's Pallas ``interpret`` flag has no meaning here:
:meth:`from_dict` accepts and drops it, :meth:`to_dict` writes it as
``None`` so a dict round-trips through either package.  The calibration
capture hook and npz artifacts are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VALID_BACKENDS = ("off", "mask", "topk_shared", "topk_block", "pallas")

# serving phases (paper §5.1 recipe: dense first fraction of prefill,
# sparse later prefill chunks and all decode steps)
PHASES = ("prefill_dense", "prefill_sparse", "decode")


def _check_backend(b, where: str):
    if b not in VALID_BACKENDS:
        raise ValueError(
            f"unknown sparsity backend {b!r} in {where}; "
            f"valid backends: {', '.join(VALID_BACKENDS)}")


@dataclasses.dataclass(frozen=True)
class SparsityPolicy:
    """Static, hashable execution policy for every ``project()`` call.

    backend        default backend for every projection
    k_max_frac     static upper bound on the kept channel fraction
    block          channel-block size
    role_backends  ((role, backend), ...) overrides by projection role
                   (``"attn/wq"``, or a bare leaf name such as ``"wo"``);
                   role matches win over depth ranges
    block_backends ((start, end, backend), ...) overrides by model depth
                   (half-open ranges)
    dense_phases   serving phases forced dense by :meth:`for_phase`
    """

    backend: str = "off"
    k_max_frac: float = 1.0
    block: int = 128
    role_backends: Tuple[Tuple[str, str], ...] = ()
    block_backends: Tuple[Tuple[int, int, str], ...] = ()
    dense_phases: Tuple[str, ...] = ("prefill_dense",)

    def __post_init__(self):
        for f in ("role_backends", "block_backends", "dense_phases"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(
                    tuple(e) if isinstance(e, list) else e for e in v))
        _check_backend(self.backend, "SparsityPolicy.backend")
        for role, b in self.role_backends:
            _check_backend(b, f"role_backends[{role!r}]")
        for s, e, b in self.block_backends:
            _check_backend(b, f"block_backends[{s}:{e}]")
            if not (isinstance(s, int) and isinstance(e, int) and s < e):
                raise ValueError(
                    f"block_backends range ({s}, {e}) must be a half-open "
                    "int range with start < end")
        for ph in self.dense_phases:
            if ph not in PHASES:
                raise ValueError(
                    f"unknown phase {ph!r} in dense_phases; "
                    f"valid phases: {', '.join(PHASES)}")
        if not (0.0 < self.k_max_frac <= 1.0):
            raise ValueError(
                f"k_max_frac must be in (0, 1], got {self.k_max_frac}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")

    # ------------------------------------------------------------------
    @classmethod
    def dense(cls, **kw) -> "SparsityPolicy":
        """All-dense execution (every projection runs the plain matmul)."""
        return cls(backend="off", **kw)

    @classmethod
    def uniform(cls, backend: str, k_max_frac: float = 1.0,
                **kw) -> "SparsityPolicy":
        """One backend for every projection."""
        return cls(backend=backend, k_max_frac=k_max_frac, **kw)

    # ------------------------------------------------------------------
    def backend_at(self, depth: Optional[int] = None,
                   role: Optional[str] = None) -> str:
        """Backend for a projection at ``depth`` with role ``role``.
        Role overrides win, then depth ranges, then the default."""
        if role is not None:
            leaf = role.rsplit("/", 1)[-1]
            for r, b in self.role_backends:
                if role == r or leaf == r:
                    return b
        if depth is not None:
            for s, e, b in self.block_backends:
                if s <= depth < e:
                    return b
        return self.backend

    def resolve_depth(self, depth: int) -> "SparsityPolicy":
        """Fold the depth-range map into the default backend for one
        block — the per-layer policy the layer loop dispatches on."""
        if not self.block_backends:
            return self
        return dataclasses.replace(
            self, backend=self.backend_at(depth=depth), block_backends=())

    def off(self) -> "SparsityPolicy":
        """This policy with every projection forced dense."""
        if self.is_dense:
            return self
        return dataclasses.replace(self, backend="off", role_backends=(),
                                   block_backends=())

    def for_phase(self, phase: str) -> "SparsityPolicy":
        """Policy for one serving phase — the §5.1 switch.  Phases listed
        in ``dense_phases`` run dense; the others run this policy."""
        if phase not in PHASES:
            raise ValueError(
                f"unknown phase {phase!r}; valid phases: {', '.join(PHASES)}")
        return self.off() if phase in self.dense_phases else self

    @property
    def is_dense(self) -> bool:
        return self.backend == "off" and not self.role_backends \
            and not self.block_backends

    def prefix_deterministic(self) -> bool:
        """True when every backend this policy can select is per-token
        (``off`` or ``mask``), so a position's output depends only on the
        token prefix — never on chunking or batch composition."""
        backends = {self.backend}
        backends.update(b for _, b in self.role_backends)
        backends.update(b for _, _, b in self.block_backends)
        return backends <= {"off", "mask"}

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-serializable policy config, in the JAX package's form."""
        return {
            "backend": self.backend,
            "k_max_frac": self.k_max_frac,
            "block": self.block,
            "interpret": None,
            "role_backends": [list(e) for e in self.role_backends],
            "block_backends": [list(e) for e in self.block_backends],
            "dense_phases": list(self.dense_phases),
        }

    @classmethod
    def from_dict(cls, p: dict) -> "SparsityPolicy":
        return cls(
            backend=p["backend"], k_max_frac=p["k_max_frac"],
            block=p["block"],
            role_backends=tuple(tuple(e) for e in p["role_backends"]),
            block_backends=tuple(tuple(e) for e in p["block_backends"]),
            dense_phases=tuple(p["dense_phases"]))
