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
``None`` so a dict round-trips through either package.

A calibrated plan becomes a policy through :meth:`from_plan`, and ships
as the self-contained npz artifact of :meth:`save` / :meth:`load`, in
the JAX package's format (versions 1-4): an artifact written by either
package loads in the other.  The ladder kind of artifact is read and
written by :class:`repro_torch.sparsity.ladder.PolicyLadder`, on the
helpers below.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

VALID_BACKENDS = ("off", "mask", "topk_shared", "topk_block", "pallas")

# serving phases (paper §5.1 recipe: dense first fraction of prefill,
# sparse later prefill chunks and all decode steps)
PHASES = ("prefill_dense", "prefill_sparse", "decode")

# artifact versions, as the JAX package writes them: v2 added the "kind"
# discriminator (policy or ladder), v3 a null "interpret", v4 optional
# quality baselines in ladder artifacts
ARTIFACT_VERSION = 4
_READABLE_VERSIONS = (1, 2, 3, 4)


class CaptureSink:
    """Calibration hook: when attached to a policy, every projection
    records ``(id(w), x)`` here before it dispatches, so
    :mod:`repro_torch.core.calibration` gathers per-linear inputs without
    instrumenting the models.  The port runs eagerly, so every call
    records.  Identity-hashed, so a policy carrying a sink stays
    hashable."""

    __slots__ = ("records",)

    def __init__(self, records=None):
        self.records = [] if records is None else records

    def record(self, w, x):
        self.records.append((id(w), x.detach()))

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)


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
    capture        optional :class:`CaptureSink` calibration hook
    """

    backend: str = "off"
    k_max_frac: float = 1.0
    block: int = 128
    role_backends: Tuple[Tuple[str, str], ...] = ()
    block_backends: Tuple[Tuple[int, int, str], ...] = ()
    dense_phases: Tuple[str, ...] = ("prefill_dense",)
    capture: Optional[CaptureSink] = None

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

    @classmethod
    def from_plan(cls, plan, backend: str = "topk_shared",
                  sensitive_backend: Optional[str] = None,
                  sensitive_frac: float = 0.25,
                  k_max_frac: Optional[float] = None,
                  **kw) -> "SparsityPolicy":
        """Policy for a calibrated
        :class:`repro_torch.core.pipeline.SparsePlan`.

        ``k_max_frac`` defaults to the plan's largest per-layer keep ratio
        (the tightest static bound that never truncates ``keep_frac``).
        With ``sensitive_backend`` set, the blocks with the *lowest* prune
        ratios, the ones the evolutionary search found most sensitive, get
        that backend while the rest run ``backend``."""
        ratios = np.asarray(plan.block_ratios, dtype=float)
        if k_max_frac is None:
            layer_ratios = getattr(plan, "layer_ratios", None) or {}
            prune_min = min(layer_ratios.values()) if layer_ratios \
                else (float(ratios.min()) if ratios.size else 0.0)
            k_max_frac = float(np.clip(1.0 - prune_min, 1e-3, 1.0))
        block_backends = ()
        if sensitive_backend is not None and ratios.size:
            n_sens = max(1, int(round(ratios.size * sensitive_frac)))
            order = np.argsort(ratios, kind="stable")
            sens = sorted(int(i) for i in order[:n_sens])
            block_backends = _merge_ranges(sens, sensitive_backend)
        return cls(backend=backend, k_max_frac=k_max_frac,
                   block_backends=block_backends, **kw)

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

    def resolve_depth(self, depth: Optional[int]) -> "SparsityPolicy":
        """Fold the depth-range map into the default backend for one
        block — the per-layer policy the layer loop dispatches on.
        ``None`` (whisper's encoder, outside the decoder's depths) folds
        it into the default backend alone."""
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

    @classmethod
    def from_artifact_dict(cls, p: dict, version: int) -> "SparsityPolicy":
        """:meth:`from_dict` for an artifact of ``version``.  The JAX
        package normalizes the ``interpret`` flag of v<=2 artifacts
        here; the port drops that flag, so every readable version reads
        alike."""
        return cls.from_dict(p)

    # ------------------------------------------------------------------
    # self-contained artifact (policy + sp tree, including g)
    # ------------------------------------------------------------------
    def save(self, path: str, sp=None) -> None:
        """Persist a versioned, self-contained npz artifact: the policy
        config plus (optionally) the stacked sp tree, ratios, alphas,
        taus and the weight-column norms ``g``, so a calibrated plan
        serves without the model checkpoint."""
        meta = {"version": ARTIFACT_VERSION, "kind": "policy",
                "policy": self.to_dict()}
        arrays = {}
        if sp is not None:
            arrays = {f"sp/{k}": v for k, v in _flatten_sp(sp).items()}
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.array(json.dumps(meta)), **arrays)

    @classmethod
    def load(cls, path: str, device="cpu"):
        """Load a saved artifact -> ``(policy, sp_or_None)``, the sp
        tree's tensors on ``device``.  Needs no model params."""
        meta, z = _read_artifact(path)
        if meta.get("kind", "policy") != "policy":
            raise ValueError(
                f"{path} is a {meta['kind']!r} artifact; load it with "
                "repro_torch.sparsity.PolicyLadder.load")
        pol = cls.from_artifact_dict(meta["policy"], meta["version"])
        flat = {k[len("sp/"):]: z[k] for k in z.files if k.startswith("sp/")}
        return pol, (_unflatten_sp(flat, device) if flat else None)


def _read_artifact(path: str):
    """npz artifact reader -> (meta dict, npz handle); checks that the
    file is an artifact of a readable version (policy and ladder kinds
    alike)."""
    z = np.load(path)
    if "__meta__" not in z.files:
        raise ValueError(f"{path} is not a sparsity artifact")
    meta = json.loads(str(z["__meta__"][()]))
    version = meta.get("version")
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"unsupported sparsity artifact version {version!r} "
            f"(this build reads versions {_READABLE_VERSIONS})")
    return meta, z


def _merge_ranges(depths, backend: str):
    """Sorted depth list -> ((start, end, backend), ...) contiguous runs."""
    out, start, prev = [], None, None
    for d in depths:
        if start is None:
            start = prev = d
        elif d == prev + 1:
            prev = d
        else:
            out.append((start, prev + 1, backend))
            start = prev = d
    if start is not None:
        out.append((start, prev + 1, backend))
    return tuple(out)


def _flatten_sp(sp) -> dict:
    """Nested list/dict sp tree -> {"0/l0/attn/wq/g": ndarray, ...}."""
    flat = {}

    def rec(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{i}/")
        else:
            t = torch.as_tensor(node).detach().cpu()
            flat[prefix[:-1]] = t.numpy()

    rec(sp, "")
    return flat


def _unflatten_sp(flat: dict, device="cpu"):
    """Inverse of :func:`_flatten_sp` for stacked sp trees (a list over
    layer groups of nested dicts of tensors on ``device``)."""
    device = torch.device(device)
    groups = {}
    for key, arr in flat.items():
        parts = key.split("/")
        gi = int(parts[0])
        node = groups.setdefault(gi, {})
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr)).to(device)
    return [groups[i] for i in range(len(groups))]
