"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block (port of the
JAX package's ``models/ssm.py``).

Prefill and train run the chunked SSD algorithm: the sequence is cut into
chunks of length L, each chunk's quadratic (attention-like) term and its
local state are computed for all chunks at once, and only the inter-chunk
state recurrence runs as a loop over chunks.  Decode is the O(1)
recurrent state update.  ngroups is fixed at 1.

The dtypes are the reference's: the SSM state, ``dt`` (softplus in f32)
and ``A = -exp(A_log)`` are f32; the depthwise causal conv accumulates in
f32 and returns the input's dtype; the scan's ``y`` is cast to the conv
output's dtype per chunk, then ``+ D * x`` in f32 and cast to the block
input's dtype before the gated RMSNorm.

WiSparse: the five input projections (``mamba/in_*``) and ``out_proj``
are channel-sparsifiable linears and run through ``dense`` under the
policy; the conv and the SSD recurrence stay dense.

Caches (``{"conv_x", "conv_B", "conv_C", "ssm"}``): the conv caches hold
the last ``W - 1`` *pre-activation* projected inputs, left-padded with
zeros when the prompt is shorter, and ``ssm`` the f32 state (B, H, P, N).
In decode they are the slot pool's own tensors, written in place (the
decode step is captured as a CUDA graph that reads and writes the same
storage).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import dense, rmsnorm, silu
from repro_torch.models.params import ParamSpec

# logical axes of the conv inputs' channels: x's are d_inner ("mlp"),
# B's and C's the state size (replicated), as in the cache schema
_CONV_AXES = {"conv_x": "mlp", "conv_B": None, "conv_C": None}


def mamba_schema(cfg):
    d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_nheads, cfg.ssm_conv)
    return {
        "in_z": ParamSpec((d, di), ("embed", "mlp")),
        "in_x": ParamSpec((d, di), ("embed", "mlp")),
        "in_B": ParamSpec((d, n), ("embed", None)),
        "in_C": ParamSpec((d, n), ("embed", None)),
        "in_dt": ParamSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((w, di), (None, "mlp"), scale=0.5),
        "conv_B": ParamSpec((w, n), (None, None), scale=0.5),
        "conv_C": ParamSpec((w, n), (None, None), scale=0.5),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="ssm_A",
                           dtype="float32"),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="ssm_dt",
                             dtype="float32"),
        "norm": ParamSpec((di,), (None,), init="zeros"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def causal_conv(u, w, name: str):
    """:func:`_causal_conv` on local shards under a mesh (rows and
    channels are independent); ``name`` is the conv's param name."""
    c = _CONV_AXES[name]
    return sharding.local_call(_causal_conv, (u, w),
                               (("batch", None, c), (None, c)),
                               ("batch", None, c))


def conv_step(state, u_new, w, name: str):
    """:func:`_conv_step` on local shards under a mesh."""
    c = _CONV_AXES[name]
    return sharding.local_call(
        _conv_step, (state, u_new, w),
        (("batch", None, c), ("batch", c), (None, c)),
        (("batch", c), ("batch", None, c)))


def conv_tail(u, w: int, name: str):
    """:func:`_conv_tail` on local shards under a mesh."""
    c = _CONV_AXES[name]
    return sharding.local_call(lambda u: _conv_tail(u, w), (u,),
                               (("batch", None, c),), ("batch", None, c))


def _causal_conv(u, w):
    """Depthwise causal conv, u: (B,S,C), w: (W,C): tap i reads the input
    ``W - 1 - i`` positions back, summed in f32 in tap order, cast to u's
    dtype (not ``F.conv1d``, whose bf16 path sums in another order)."""
    W, S = w.shape[0], u.shape[1]
    uf, wf = u.float(), w.float()
    out = torch.zeros_like(uf)
    for i in range(W):
        shift = W - 1 - i
        out = out + F.pad(uf, (0, 0, shift, 0))[:, :S] * wf[i]
    return out.to(u.dtype)


def _conv_step(state, u_new, w):
    """state: (B,W-1,C) last inputs; u_new: (B,C) -> (out (B,C), the new
    window (B,W-1,C), a fresh tensor)."""
    hist = torch.cat([state, u_new[:, None].to(state.dtype)], 1)  # (B,W,C)
    out = torch.einsum("bwc,wc->bc", hist.float(), w.float())
    return out.to(u_new.dtype), hist[:, 1:]


def _project_inputs(p, x, sp, policy=None, token_weights=None):
    sp = sp or {}

    def proj(name):
        return dense(x, p[name], sp.get(name), policy=policy,
                     role=f"mamba/{name}", token_weights=token_weights)

    return (proj("in_z"), proj("in_x"), proj("in_B"), proj("in_C"),
            proj("in_dt"))


def chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk length: ``min(chunk, S)``, lowered until it
    divides S (a prime S falls to 1)."""
    L = max(1, min(chunk, S))
    while S % L:
        L -= 1
    return L


def ssd(xh, dt, A, Bm, Cm, chunk: int):
    """:func:`ssd_chunked` on local shards under a mesh: rows and heads
    are independent."""
    return sharding.local_call(
        lambda xh, dt, A, Bm, Cm: ssd_chunked(xh, dt, A, Bm, Cm, chunk),
        (xh, dt, A, Bm, Cm),
        (("batch", None, "ssm_heads", None), ("batch", None, "ssm_heads"),
         ("ssm_heads",), ("batch", None, None), ("batch", None, None)),
        (("batch", None, "ssm_heads", None),
         ("batch", "ssm_heads", None, None)))


def _ssm_step(state, dt, A, Bm, Cm, xh, Dp):
    """One recurrent SSD step: state (B,H,P,N) f32, dt (B,H), Bm/Cm
    (B,N), xh (B,H,P) f32 -> (y (B,H,P) f32, the new state)."""
    dA = torch.exp(dt * A)                                      # (B,H)
    S_new = (state * dA[..., None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh))
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), S_new)
    return y + Dp[:, None] * xh, S_new


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    xh: (B,S,H,P); dt: (B,S,H) (already softplus'd); A: (H,) < 0;
    Bm/Cm: (B,S,N).  Returns (y: (B,S,H,P) in xh's dtype, final_state:
    (B,H,P,N) f32).

    The intra-chunk quadratic term and each chunk's own state are
    batched over the chunks; the recurrence ``S_c = S_{c-1} *
    exp(cum_last) + Sc`` runs as a loop over chunks (one fused
    multiply-add each), and the carried state's term joins y after it."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    L = chunk_len(S, chunk)
    nc = S // L
    xc = xh.reshape(Bsz, nc, L, H, P).float()
    dtc = dt.reshape(Bsz, nc, L, H).float()
    Bc = Bm.reshape(Bsz, nc, L, N).float()
    Cc = Cm.reshape(Bsz, nc, L, N).float()

    cum = torch.cumsum(dtc * A, dim=2)                   # (B,nc,L,H), < 0
    # intra-chunk quadratic term
    sc = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    idx = torch.arange(L, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]          # (L,M,1)
    decay = torch.where(causal, torch.exp(cum[:, :, :, None]
                                          - cum[:, :, None]), 0.0)
    att = sc[..., None] * decay * dtc[:, :, None]                # (B,nc,L,M,H)
    y = torch.einsum("bclmh,bcmhp->bclhp", att, xc)
    del sc, decay, att
    # each chunk's own state, then the recurrence over chunks
    to_end = torch.exp(cum[:, :, -1:] - cum) * dtc               # (B,nc,L,H)
    Sc = torch.einsum("bclh,bcln,bclhp->bchpn", to_end, Bc, xc)
    last = torch.exp(cum[:, :, -1])[..., None, None]             # (B,nc,H,1,1)
    if init_state is None:
        state = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                            device=xh.device)
    else:
        state = init_state.float()
    entering = torch.empty_like(Sc)        # the state entering each chunk
    for c in range(nc):
        entering[:, c] = state
        state = torch.addcmul(Sc[:, c], state, last[:, c])
    # the carried state's contribution to each chunk
    y = y + torch.einsum("bcln,bchpn->bclhp", Cc, entering) * \
        torch.exp(cum)[..., None]
    return y.to(xh.dtype).reshape(Bsz, S, H, P), state


def _conv_tail(u, w: int):
    """The last ``w - 1`` positions of u (B,S,C), left-padded with zeros
    when S < w - 1: the conv cache a prefill leaves."""
    S = u.shape[1]
    if S < w - 1:
        u = F.pad(u, (0, 0, w - 1 - S, 0))
    return u[:, -(w - 1):]


def mamba_apply(p, x, cfg, sp=None, cache=None, mode: str = "train",
                policy=None, token_weights=None):
    """x: (B,S,D) for train/prefill, (B,1,D) for decode.

    Returns (out, cache): None in train, fresh caches in prefill, and in
    decode ``cache`` itself (the pool's views), updated in place."""
    H, P = cfg.ssm_nheads, cfg.ssm_head_dim
    A = -torch.exp(p["A_log"].float())
    Dp = p["D"].float()
    sp = sp or {}

    if mode == "decode":
        xt = x[:, 0]
        z, xs, Bm, Cm, dt = _project_inputs(p, xt, sp, policy, token_weights)
        xs, conv_x = conv_step(cache["conv_x"], xs, p["conv_x"], "conv_x")
        Bm, conv_B = conv_step(cache["conv_B"], Bm, p["conv_B"], "conv_B")
        Cm, conv_C = conv_step(cache["conv_C"], Cm, p["conv_C"], "conv_C")
        xs, Bm, Cm = silu(xs), silu(Bm), silu(Cm)
        dt = F.softplus(dt.float() + p["dt_bias"])
        xh = sharding.unflatten(xs, -1, (H, P)).float()
        y, S_new = sharding.local_call(
            _ssm_step, (cache["ssm"], dt, A, Bm, Cm, xh, Dp),
            (("batch", "ssm_heads", None, None), ("batch", "ssm_heads"),
             ("ssm_heads",), ("batch", None), ("batch", None),
             ("batch", "ssm_heads", None), ("ssm_heads",)),
            (("batch", "ssm_heads", None), ("batch", "ssm_heads", None, None)))
        y = sharding.flatten(y, 1, 2).to(x.dtype)
        y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
        out = dense(y, p["out_proj"], sp.get("out_proj"), True,
                    policy=policy, role="mamba/out_proj",
                    token_weights=token_weights)
        # the new windows and state are fresh tensors: no copy overlaps
        # its source
        cache["conv_x"].copy_(conv_x)
        cache["conv_B"].copy_(conv_B)
        cache["conv_C"].copy_(conv_C)
        cache["ssm"].copy_(S_new)
        return out[:, None], cache

    B, S, _ = x.shape
    z, xs, Bm, Cm, dt = _project_inputs(p, x, sp, policy, token_weights)
    raw = (xs, Bm, Cm)          # pre-conv inputs: their tails feed the cache
    xs = silu(causal_conv(xs, p["conv_x"], "conv_x"))
    Bm = silu(causal_conv(Bm, p["conv_B"], "conv_B"))
    Cm = silu(causal_conv(Cm, p["conv_C"], "conv_C"))
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = sharding.unflatten(xs, -1, (H, P))
    xh = constrain(xh, "batch", None, "ssm_heads", None)
    y, S_fin = ssd(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y.float() + Dp[None, None, :, None] * xh.float()
    y = sharding.flatten(y, 2, 2).to(x.dtype)
    y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
    out = dense(y, p["out_proj"], sp.get("out_proj"), True, policy=policy,
                role="mamba/out_proj", token_weights=token_weights)
    new_cache = None
    if mode == "prefill":
        w = cfg.ssm_conv
        new_cache = {"conv_x": conv_tail(raw[0], w, "conv_x"),
                     "conv_B": conv_tail(raw[1], w, "conv_B"),
                     "conv_C": conv_tail(raw[2], w, "conv_C"), "ssm": S_fin}
    return out, new_cache
