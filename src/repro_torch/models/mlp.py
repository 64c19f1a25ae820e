"""Gated MLP (SwiGLU, GeGLU) with separate gate/up/down projections
(port of the JAX package's ``models/mlp.py``; the plain-GELU ``wi`` MLP
comes with whisper)."""
from __future__ import annotations

from repro_torch.models.layers import dense, gelu, silu
from repro_torch.models.params import ParamSpec

ACTIVATIONS = {"swiglu": silu, "geglu": gelu}


def mlp_schema(cfg):
    if cfg.mlp_activation not in ACTIVATIONS:
        raise NotImplementedError(
            f"mlp_activation {cfg.mlp_activation!r}: the port runs "
            f"{sorted(ACTIVATIONS)}")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p, x, cfg, sp=None, policy=None, token_weights=None):
    sp = sp or {}
    act = ACTIVATIONS[cfg.mlp_activation]

    def proj(name, xin):
        return dense(xin, p[name], sp.get(name), policy=policy,
                     role=f"mlp/{name}", token_weights=token_weights)

    h = act(proj("wi_gate", x)) * proj("wi_up", x)
    return proj("wo", h)
