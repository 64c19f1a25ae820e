"""Public model API (port of the JAX package's ``models/api.py``): the
cache and prefix-segment schemas, model init, the loss and the train
step, the step functions the serving engine calls (slot decode, chunked
prefill, speculative verify, whole-prompt prefill), and the plain
batched prefill and decode steps, with frames (enc-dec) or patch
embeddings (VLM) beside the tokens."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.optim import adamw


def cache_schema(cfg: ModelConfig, batch: int, cache_len: int):
    """ParamSpec tree mirroring the cache structure ``run_groups`` takes:
    list over groups -> tuple over pattern positions -> one entry per
    layer: ``{"self": {k, v}}`` on an attention layer, in the decode
    layouts K (reps,B,KV,hd,T) and V (reps,B,KV,T,hd), where ``T`` is
    ``cache_len``, or ``min(sliding_window, cache_len)`` on a ``local``
    layer (its rolling window); ``{"ssm": {conv_x, conv_B, conv_C,
    ssm}}`` on a ``mamba`` layer: the last ``W - 1`` projected inputs
    (reps,B,W-1,C) in the model dtype and the f32 state (reps,B,H,P,N),
    with no time axis.  An enc-dec decoder layer adds ``{"cross": {k,
    v}}``, the static cross K/V over ``cfg.encoder_frames`` frames in the
    same layouts."""
    M.check_supported(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def kv_pair(reps, T):
        return {
            "k": P.ParamSpec((reps, batch, KV, hd, T),
                             ("layers", "batch", "kv_heads", None, "kv_seq"),
                             init="zeros"),
            "v": P.ParamSpec((reps, batch, KV, T, hd),
                             ("layers", "batch", "kv_heads", "kv_seq", None),
                             init="zeros"),
        }

    def ssm_state(reps):
        w, di, n = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
        H, Pd = cfg.ssm_nheads, cfg.ssm_head_dim

        def conv(c, axis):
            return P.ParamSpec((reps, batch, w - 1, c),
                               ("layers", "batch", None, axis), init="zeros")
        return {"ssm": {
            "conv_x": conv(di, "mlp"), "conv_B": conv(n, None),
            "conv_C": conv(n, None),
            "ssm": P.ParamSpec((reps, batch, H, Pd, n),
                               ("layers", "batch", "ssm_heads", None, None),
                               init="zeros", dtype="float32"),
        }}

    def entry(mixer, reps):
        if mixer == "mamba":
            e = ssm_state(reps)
        else:
            e = {"self": kv_pair(reps, min(cfg.sliding_window, cache_len)
                                 if mixer == "local" else cache_len)}
        if cfg.family == "encdec":
            e["cross"] = kv_pair(reps, cfg.encoder_frames)
        return e

    return [tuple(entry(mixer, reps) for mixer, _ffn in pattern)
            for pattern, reps in cfg.layer_groups()]


def pad_caches(cfg: ModelConfig, caches, batch: int, total_len: int):
    """Prefill caches zero-padded to :func:`cache_schema`'s shapes at
    ``total_len`` positions and cast to the model dtype (the reference's
    ``launch/serve._pad_caches``): the self caches grow along T, the
    cross caches (F frames) stay as they are.  Under a mesh each leaf
    is gathered, padded and placed again by its logical axes."""
    def fit(src, spec):
        if sharding.is_sharded(src):
            return sharding.place(fit(src.full_tensor(), spec), spec.axes)
        pads = []                 # F.pad lists the last dim's pads first
        for have, want in zip(reversed(src.shape), reversed(spec.shape)):
            pads += [0, want - have]
        return torch.nn.functional.pad(src, pads).to(
            P.DTYPES[spec.dtype or cfg.dtype])

    specs = P.tree_leaves(cache_schema(cfg, batch, total_len))
    return P.tree_unflatten_like(caches, [
        fit(src, spec)
        for src, spec in zip(P.tree_leaves(caches), specs, strict=True)])


def prefix_segment_schema(cfg: ModelConfig, length: int):
    """Schema of one slot's KV *prefix segment*, the unit the serving
    prefix cache and preemption copy out of and into the slot pool: the
    cache tree of one sequence (batch 1) cut to ``length`` positions
    (the window of a ``local`` layer, where that is shorter).
    Deriving it from :func:`cache_schema` keeps the segment layout and
    the pool layout in lockstep."""
    return cache_schema(cfg, 1, length)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zero caches of :func:`cache_schema`'s shapes in the model dtype."""
    return P.init_params(cache_schema(cfg, batch, cache_len), 0, cfg.dtype,
                         resolve_device(device))


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` on ``device`` (default the card;
    raises if CUDA is absent unless ``device="cpu"``)."""
    return P.init_params(M.model_schema(cfg), seed, cfg.dtype,
                         resolve_device(device))


# ---------------------------------------------------------------------------
# Loss / steps
# ---------------------------------------------------------------------------

def token_loss(cfg: ModelConfig, logits, tokens, text_start: int = 0):
    """Next-token CE in f32.  logits: (B,S,V) over [prefix+]text positions.
    Under a mesh each rank takes its rows' losses over the whole vocab
    (the logits' vocab shards are gathered), and the mean reduces over
    every rank's rows."""
    return sharding.local_call(
        lambda lg, tok: _token_nll(lg, tok, text_start), (logits, tokens),
        (("batch", None, None), ("batch", None)), ("batch", None)).mean()


def _token_nll(logits, tokens, text_start: int):
    """(B,S-1) next-token losses."""
    lg = logits[:, text_start: -1].float() if logits.shape[1] > 1 \
        else logits.float()
    labels = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, -1)
    picked = torch.take_along_dim(lg, labels[..., None], -1)[..., 0]
    return lse - picked


def _multimodal_inputs(cfg: ModelConfig, batch) -> dict:
    """The forward's frames (enc-dec) or patch embeddings (VLM) from
    ``batch``; a batch without them raises ``KeyError``, as the
    reference's steps do."""
    if cfg.family == "vlm":
        return {"patch_embeds": batch["patch_embeds"]}
    if cfg.family == "encdec":
        return {"frames": batch["frames"]}
    return {}


def make_loss_fn(cfg: ModelConfig, remat: str = "none", policy=None):
    """``policy``: the SparsityPolicy baked into the returned callable
    (override per call via the ``policy=`` kwarg).  ``batch`` holds
    ``tokens`` and, for a VLM, ``patch_embeds`` (the loss skips the
    prefix positions: ``text_start = vision_prefix``) or, for enc-dec,
    ``frames``."""
    M.check_supported(cfg)
    text_start = cfg.vision_prefix if cfg.family == "vlm" else 0

    def loss_fn(params, batch, sp=None, policy=policy):
        logits, _ = M.forward(params, cfg, tokens=batch["tokens"],
                              mode="train", sp=sp, remat=remat,
                              policy=policy,
                              **_multimodal_inputs(cfg, batch))
        return token_loss(cfg, logits, batch["tokens"], text_start)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    remat: str = "none", accum_steps: int = 1, policy=None):
    """``train_step(params, opt_state, batch, sp=None) -> (params,
    opt_state, {"loss", "grad_norm", "lr"})``: grads of the loss over
    every param leaf by ``torch.autograd``, then one AdamW update, which
    writes params and state in place.  With ``accum_steps`` > 1 the batch
    splits into ``accum_steps`` micro-batches (``reshape((accum, -1) +
    shape)``) whose loss and grads sum in f32 from zeros, then divide.
    A ``pallas`` projection under an sp tree raises
    ``NotImplementedError``: the kernels have no backward, as in the
    reference."""
    loss_fn = make_loss_fn(cfg, remat, policy=policy)

    def value_and_grad(params, leaves, batch, sp):
        try:
            with torch.enable_grad():
                for leaf in leaves:
                    leaf.requires_grad_(True)
                loss = loss_fn(params, batch, sp)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        return loss.detach(), grads

    def train_step(params, opt_state, batch, sp=None):
        leaves = P.tree_leaves(params)
        if accum_steps == 1:
            loss, grads = value_and_grad(params, leaves, batch, sp)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            mbs = {k: v.reshape((accum_steps, -1) + v.shape[1:])
                   for k, v in batch.items()}
            for i in range(accum_steps):
                l, g = value_and_grad(params, leaves,
                                      {k: v[i] for k, v in mbs.items()}, sp)
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = loss / accum_steps
            grads = [acc / accum_steps for acc in grads]
        params, opt_state, metrics = adamw.update(
            P.tree_unflatten_like(params, grads), opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, policy=None):
    """``prefill_step(params, tokens, sp=None, policy=policy, frames=None,
    patch_embeds=None) -> (last-position logits (B,V), fresh caches)``;
    an enc-dec prefill with frames stashes each layer's cross K/V.
    ``policy`` is baked in, as the reference's (override per call)."""
    def prefill_step(params, tokens, sp=None, policy=policy, frames=None,
                     patch_embeds=None):
        return M.forward(params, cfg, tokens=tokens, mode="prefill", sp=sp,
                         policy=policy, frames=frames,
                         patch_embeds=patch_embeds)
    return prefill_step


def make_decode_step(cfg: ModelConfig, policy=None, aligned: bool = False):
    """The plain batched decode step (the reference's
    ``make_decode_step``): ``decode_step(params, batch, sp=None,
    policy=policy)`` with ``batch`` = {tokens (B,), positions (B,),
    caches} -> (logits (B,V), caches updated in place).  Every row
    weighs alike in the shared saliency.  ``aligned``: every row decodes
    ``positions[0]``, so each cache write is one slice write."""
    def decode_step(params, batch, sp=None, policy=policy):
        return M.forward(params, cfg, tokens=batch["tokens"], mode="decode",
                         caches=batch["caches"],
                         positions=batch["positions"], sp=sp, policy=policy,
                         aligned=aligned)
    return decode_step


def make_slot_decode_step(cfg: ModelConfig):
    """Continuous-batching decode over the slot pool: one token per slot
    at per-slot positions, with the active-slot mask weighting the shared
    top-k saliency (``active`` rides in as token weights)."""
    def slot_decode_step(params, tokens, positions, caches, sp=None,
                         active=None, policy=None):
        return M.forward(params, cfg, tokens=tokens, mode="decode",
                         caches=caches, positions=positions, sp=sp,
                         policy=policy, token_weights=active)
    return slot_decode_step


def make_chunk_prefill_step(cfg: ModelConfig):
    """Chunked prefill of one request directly into the slot pool: tokens
    (1,C) at chunk-start ``offset`` (a (1,) int tensor) for pool ``slot``
    (a 0-d int tensor), both on the device so the step can be captured.
    Pad tokens of the final chunk carry zero ``weights``.  Returns logits
    for every chunk position and the (in-place updated) pool."""
    def chunk_prefill_step(params, tokens, offset, slot, caches, sp=None,
                           weights=None, policy=None):
        return M.forward(params, cfg, tokens=tokens, mode="chunk",
                         caches=caches, positions=offset, sp=sp, slot=slot,
                         policy=policy, token_weights=weights)
    return chunk_prefill_step


def make_verify_step(cfg: ModelConfig):
    """Speculative-decoding verify: a fixed-length multi-token decode over
    the slot pool, on the chunk step's write-in-place path.  ``tokens``
    (S, gamma+1): row s is slot s's last committed token followed by its
    gamma drafts, at per-slot start offsets ``positions`` (S,).  K/V of
    every window position are projected under the verifier's policy and
    written in place before the window attends, so the committed prefix
    is always the verifier's.  ``weights`` (S, gamma+1) masks inactive
    slots out of the shared saliency.  Returns logits for every window
    position (S, gamma+1, V) and the (in-place updated) pool.

    Refused at once on an arch with ``mamba`` or ``local`` layers (the
    reference refuses the verify forward there): an SSM state has no
    time axis to write a window into, and a rolling-window cache cannot
    roll back, so neither speculative decoding nor the quality monitor's
    probe, a window-1 verify, runs on them."""
    if M.has_ssm(cfg):
        raise NotImplementedError(
            "chunked prefill / speculative verify do not support SSM "
            "layers; use the engine's whole-prompt prefill strategy")
    if not M.chunkable(cfg):
        raise NotImplementedError(
            "speculative verify does not support local-attention "
            "layers (rolling-window caches cannot roll back)")

    def verify_step(params, tokens, positions, caches, sp=None,
                    weights=None, policy=None):
        return M.forward(params, cfg, tokens=tokens, mode="verify",
                         caches=caches, positions=positions, sp=sp,
                         policy=policy, token_weights=weights)
    return verify_step


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors, no allocation) for the dry run
# ---------------------------------------------------------------------------

INT = torch.int32


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=None):
    """Meta-tensor inputs of an (arch x shape) cell.  For decode shapes
    this is the decode step's ``batch``: one new token per row and the
    caches at ``seq_len``."""
    dt = P.DTYPES[dtype or cfg.dtype]
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, d):
        return torch.empty(shp, dtype=d, device="meta")

    if shape.mode in ("train", "prefill"):
        specs = {}
        if cfg.family == "vlm":
            Ptok = cfg.vision_prefix
            specs["patch_embeds"] = meta((B, Ptok, cfg.d_model), dt)
            specs["tokens"] = meta((B, S - Ptok), INT)
        elif cfg.family == "encdec":
            specs["frames"] = meta((B, cfg.encoder_frames, cfg.d_model), dt)
            specs["tokens"] = meta((B, S), INT)
        else:
            specs["tokens"] = meta((B, S), INT)
        return specs
    return {
        "tokens": meta((B,), INT),
        "positions": meta((B,), INT),
        "caches": P.abstract_params(cache_schema(cfg, B, S),
                                    dtype or cfg.dtype),
    }


def input_axes(cfg: ModelConfig, shape: ShapeConfig):
    """Logical axes tree matching :func:`input_specs`."""
    if shape.mode in ("train", "prefill"):
        axes = {"tokens": ("batch", "seq")}
        if cfg.family == "vlm":
            axes["patch_embeds"] = ("batch", "seq", "embed_act")
        elif cfg.family == "encdec":
            axes["frames"] = ("batch", "seq", "embed_act")
        return axes
    return {
        "tokens": ("batch",),
        "positions": ("batch",),
        "caches": P.logical_axes(cache_schema(cfg, shape.global_batch,
                                              shape.seq_len)),
    }


def step_for_shape(cfg: ModelConfig, shape: ShapeConfig,
                   opt_cfg: Optional[adamw.AdamWConfig] = None,
                   remat: str = "none", policy=None, aligned: bool = False):
    """The step a dry-run cell runs, and its kind: ``train`` ->
    ``step(params, opt_state, batch, sp=None)`` (loss, grads, AdamW);
    ``prefill`` and ``decode`` -> ``step(params, batch, sp=None)``.
    ``policy`` is baked into the step; ``aligned`` selects the one-slice
    decode cache write."""
    if shape.mode == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        return make_train_step(cfg, opt_cfg, remat=remat,
                               policy=policy), "train"
    if shape.mode == "prefill":
        prefill = make_prefill_step(cfg, policy=policy)

        def prefill_step(params, batch, sp=None):
            return prefill(params, batch["tokens"], sp,
                           **_multimodal_inputs(cfg, batch))
        return prefill_step, "prefill"
    return make_decode_step(cfg, policy=policy, aligned=aligned), "decode"


def abstract_model(cfg: ModelConfig):
    """(meta params in the schema's dtypes, their logical axes, the
    schema)."""
    schema = M.model_schema(cfg)
    return (P.abstract_params(schema, cfg.dtype), P.logical_axes(schema),
            schema)
