"""Gated MLP (SwiGLU, GeGLU) with separate gate/up/down projections, and
whisper's plain ``wi`` -> GELU -> ``wo`` MLP (port of the JAX package's
``models/mlp.py``)."""
from __future__ import annotations

from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import dense, gelu, silu
from repro_torch.models.params import ParamSpec

GATED = {"swiglu": silu, "geglu": gelu}
# whisper's plain MLP
PLAIN = ("gelu",)


def mlp_schema(cfg):
    """Gate/up/down for a gated activation, ``wi`` and ``wo`` for
    whisper's plain GELU.  Any other activation raises: the reference
    would run it as GELU without a word."""
    if cfg.mlp_activation not in (*GATED, *PLAIN):
        raise NotImplementedError(
            f"mlp_activation {cfg.mlp_activation!r}: the port runs "
            f"{sorted((*GATED, *PLAIN))}")
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_activation in GATED:
        return {
            "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
            "wi_up": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p, x, cfg, sp=None, policy=None, token_weights=None):
    sp = sp or {}

    def proj(name, xin, row_parallel=False):
        return dense(xin, p[name], sp.get(name), row_parallel,
                     policy=policy, role=f"mlp/{name}",
                     token_weights=token_weights)

    if cfg.mlp_activation in GATED:
        h = GATED[cfg.mlp_activation](proj("wi_gate", x)) * proj("wi_up", x)
    else:
        h = gelu(proj("wi", x))
    h = constrain(h, "batch", None, "mlp")
    return proj("wo", h, row_parallel=True)
