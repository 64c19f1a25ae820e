"""Public model API (port of the JAX package's ``models/api.py``): the
cache schema, model init, and the step functions the serving engine
calls (slot decode, chunked prefill, speculative verify, whole-prompt
prefill)."""
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
    position (S, gamma+1, V) and the (in-place updated) pool."""
    def verify_step(params, tokens, positions, caches, sp=None,
                    weights=None, policy=None):
        return M.forward(params, cfg, tokens=tokens, mode="verify",
                         caches=caches, positions=positions, sp=sp,
                         policy=policy, token_weights=weights)
    return verify_step
