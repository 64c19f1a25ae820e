"""Public model API (port of the JAX package's ``models/api.py``): the
cache schema, model init, and the step functions the serving engine
calls (slot decode, chunked prefill, whole-prompt prefill)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import params as P


def cache_schema(cfg: ModelConfig, batch: int, cache_len: int):
    """ParamSpec tree mirroring the cache structure ``run_groups`` takes:
    list over groups -> tuple over pattern positions -> {"self": {k, v}},
    in the decode layouts K (reps,B,KV,hd,T) and V (reps,B,KV,T,hd)."""
    M.check_supported(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    groups = []
    for pattern, reps in cfg.layer_groups():
        groups.append(tuple(
            {"self": {
                "k": P.ParamSpec((reps, batch, KV, hd, cache_len),
                                 ("layers", "batch", "kv_heads", None,
                                  "kv_seq"), init="zeros"),
                "v": P.ParamSpec((reps, batch, KV, cache_len, hd),
                                 ("layers", "batch", "kv_heads", "kv_seq",
                                  None), init="zeros"),
            }} for _ in pattern))
    return groups


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zero caches of :func:`cache_schema`'s shapes in the model dtype."""
    return P.init_params(cache_schema(cfg, batch, cache_len), 0, cfg.dtype,
                         resolve_device(device))


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters from ``seed`` on ``device`` (default the card;
    raises if CUDA is absent unless ``device="cpu"``)."""
    return P.init_params(M.model_schema(cfg), seed, cfg.dtype,
                         resolve_device(device))


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, sp=None, policy=None):
        return M.forward(params, cfg, tokens=tokens, mode="prefill", sp=sp,
                         policy=policy)
    return prefill_step


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
    (1,C) at chunk-start ``offset`` (int) for pool ``slot`` (int).  Pad
    tokens of the final chunk carry zero ``weights``.  Returns logits for
    every chunk position and the (in-place updated) pool."""
    def chunk_prefill_step(params, tokens, offset, slot, caches, sp=None,
                           weights=None, policy=None):
        return M.forward(params, cfg, tokens=tokens, mode="chunk",
                         caches=caches, positions=offset, sp=sp, slot=slot,
                         policy=policy, token_weights=weights)
    return chunk_prefill_step
