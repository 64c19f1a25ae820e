"""Gated MLP (SwiGLU) with separate gate/up/down projections (port of
the JAX package's ``models/mlp.py``; the GeGLU and plain-GELU variants
come with the archs that use them)."""
from __future__ import annotations

from repro_torch.models.layers import dense, silu
from repro_torch.models.params import ParamSpec


def mlp_schema(cfg):
    if cfg.mlp_activation != "swiglu":
        raise NotImplementedError(
            f"mlp_activation {cfg.mlp_activation!r}: only swiglu is ported")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p, x, cfg, sp=None, policy=None, token_weights=None):
    sp = sp or {}

    def proj(name, xin):
        return dense(xin, p[name], sp.get(name), policy=policy,
                     role=f"mlp/{name}", token_weights=token_weights)

    h = silu(proj("wi_gate", x)) * proj("wi_up", x)
    return proj("wo", h)
