"""Prefix-sharing KV cache: radix-tree reuse over the slot pool (port of
the JAX package's ``serving/prefix_cache.py``; the radix tree is plain
Python, copied).

Production traffic is dominated by shared prompt prefixes (system
prompts, few-shot templates), yet a plain slot pool re-prefills every
request from token 0.  This module caches *immutable* prefix segments of
the KV pool in a radix tree keyed by prompt token ids:

  * ``RadixTree`` — pure-Python token-path tree.  Payload-bearing nodes
    own one cached segment each; matching walks the tree and may use a
    *longer* cached segment as the copy source for a *shorter* matched
    prefix (prefix-deterministic prefill makes position ``p``'s KV a
    function of tokens ``[0, p]`` only, so slicing a segment is exact).
    Nodes are refcount-pinned while an in-flight request uses them and
    unpinned payload leaves are evicted LRU under a token budget.
  * ``PrefixCache`` — the engine-facing layer tying the tree to a
    :class:`~repro_torch.serving.kv_pool.SlotKVPool`.  On admission the
    matched segment is copied into the request's slot at offset 0 (in
    place: the pool tensors keep their addresses, which the captured
    decode and chunk graphs hold) and only the un-cached suffix is
    chunk-prefilled; when the prefill completes the engine publishes
    the slot's prompt prefix back into the tree.

Physical segment lengths are quantized up to the engine's prefill-chunk
size, and an admission copies the *whole* physical segment.  Positions
past the matched length are garbage from the copy's perspective, which
is safe by the serving invariants: the suffix prefill rewrites
``[match, P)`` before attending each chunk, decode writes position ``p``
before any query can reach it, and every attention mask excludes
positions beyond the querying position (``attention.chunk_attention``,
the decode valid mask).  No test may rely on zeros there: a rollback
zeroes positions, a segment copy does not.

Memory trade-off: each payload node stores a *full* ``[0, end)``
segment, so an admission costs one copy and eviction is per node, at
the price of duplicating a shared system prompt's KV into every
suffix's segment; the token budget (``capacity_tokens``) is the
backstop.

Exactness contract: reuse is bit-identical to cold prefill only when
prefill is *prefix-deterministic* — every projection runs a per-token
backend (``off`` dense or ``mask``), and the effective prefill policy
does not depend on the prompt length.  The engine validates this at
construction (:meth:`repro_torch.sparsity.SparsityPolicy.prefix_deterministic`).

Telemetry (``obs_fn`` returns the engine's live ``Telemetry``): an
admission records a ``prefix_lookup`` span, an eviction a
``prefix_evict`` event, and the segment copies run under the
``repro/prefix_write`` and ``repro/prefix_extract`` profiler ranges, as
in the reference.  Its ``PrefixCache.warm`` precompiles the segment
copies; a copy here builds nothing, so it has no counterpart.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs import NULL_CONTEXT
from repro_torch.obs import now as _obs_now


class RadixNode:
    """One radix-tree node.  ``edge`` is the token span from the parent;
    ``end`` is the total token depth (prefix length) at this node.
    ``payload`` is the cached segment (opaque to the tree) covering
    positions ``[0, end)``; ``size`` its token accounting (physical,
    i.e. quantized, tokens).  Intermediate nodes created by edge splits
    carry no payload."""

    __slots__ = ("edge", "end", "parent", "children", "payload", "size",
                 "refcount", "last_used", "min_seg")

    def __init__(self, edge: Tuple[int, ...], end: int,
                 parent: Optional["RadixNode"]):
        self.edge = edge
        self.end = end
        self.parent = parent
        self.children: Dict[int, RadixNode] = {}
        self.payload = None
        self.size = 0
        self.refcount = 0
        self.last_used = 0
        # shallowest payload node in this node's subtree (self included),
        # maintained incrementally so matching is O(path), not O(subtree)
        self.min_seg: Optional[RadixNode] = None

    @property
    def path(self) -> Tuple[int, ...]:
        """Full token path from the root (test/debug helper)."""
        parts: List[Tuple[int, ...]] = []
        node: Optional[RadixNode] = self
        while node is not None:
            parts.append(node.edge)
            node = node.parent
        return tuple(t for e in reversed(parts) for t in e)


class RadixTree:
    """Radix tree over token sequences with refcounted payloads and LRU
    eviction of unpinned payload-leaves.  Payloads are opaque — the tree
    only tracks their ``size`` for the eviction budget."""

    def __init__(self):
        self.root = RadixNode((), 0, None)
        self.total_size = 0
        self._clock = 0
        self._num_payloads = 0

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def _walk(self, tokens: Tuple[int, ...]):
        """Longest tree-path prefix of ``tokens``: returns
        ``(frontier, matched)`` where ``frontier`` is the deepest node
        whose subtree extends the match (possibly mid-edge) and
        ``matched`` the number of matched tokens."""
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                return node, i
            edge = child.edge
            k, n = 0, min(len(edge), len(tokens) - i)
            while k < n and edge[k] == tokens[i + k]:
                k += 1
            i += k
            if k < len(edge):           # stopped mid-edge: child's subtree
                return child, i         # still shares the first i tokens
            node = child
        return node, i

    def match(self, tokens, limit: Optional[int] = None,
              touch: bool = True):
        """Longest usable cached prefix of ``tokens``.

        Returns ``(source, length)``: ``source`` is a payload node whose
        first ``length`` path tokens equal ``tokens[:length]`` and whose
        segment covers at least ``length`` positions (``source.end >=
        length`` — the cache layer slices it), or ``(None, 0)`` on a
        miss.  ``limit`` caps the match (the engine passes
        ``prompt_len - 1`` so at least one suffix token remains to
        produce the first-token logits).  ``touch=False`` makes the
        match a pure read (no LRU refresh) for introspection paths."""
        tokens = tuple(tokens)
        lim = len(tokens) if limit is None else min(limit, len(tokens))
        if lim <= 0:
            return None, 0
        frontier, matched = self._walk(tokens)
        depth = min(matched, lim)
        if depth > 0:
            # every node in the frontier's subtree shares the matched
            # prefix, so any payload there can source a slice; min_seg
            # is the shallowest (fewest copied bytes), maintained
            # incrementally — no per-admission subtree scan
            src = frontier.min_seg
            if src is not None and src.end >= depth:
                if touch:
                    self.touch(src)
                return src, depth
        # fall back to the deepest fully-matched ancestor payload
        node = frontier
        while node is not None:
            if node.payload is not None and 0 < node.end <= lim \
                    and node.end <= matched:
                if touch:
                    self.touch(node)
                return node, node.end
            node = node.parent
        return None, 0

    def covered(self, tokens) -> Optional[RadixNode]:
        """The payload node at exactly ``len(tokens)`` depth, if any
        (used to skip re-publishing an already-cached prompt)."""
        tokens = tuple(tokens)
        frontier, matched = self._walk(tokens)
        if matched == len(tokens) and frontier.end == matched \
                and frontier.payload is not None:
            return frontier
        return None

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------
    def _split(self, node: RadixNode, k: int) -> RadixNode:
        """Split ``node``'s edge after ``k`` tokens; returns the new
        intermediate (payload-less) parent."""
        assert 0 < k < len(node.edge)
        parent = node.parent
        mid = RadixNode(node.edge[:k], node.end - len(node.edge) + k, parent)
        parent.children[node.edge[0]] = mid
        node.edge = node.edge[k:]
        node.parent = mid
        mid.children[node.edge[0]] = node
        mid.min_seg = node.min_seg          # same subtree, new root
        return mid

    def insert(self, tokens, payload, size: int) -> RadixNode:
        """Attach ``payload`` (a segment covering ``[0, len(tokens))``)
        at the node for ``tokens``, splitting edges as needed.  An
        existing payload at that exact depth is kept (segments are
        immutable and content-deterministic) and only LRU-refreshed."""
        tokens = tuple(tokens)
        if not tokens:
            raise ValueError("cannot cache an empty prefix")
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                leaf = RadixNode(tokens[i:], len(tokens), node)
                node.children[tokens[i]] = leaf
                node = leaf
                i = len(tokens)
                break
            edge = child.edge
            k, n = 0, min(len(edge), len(tokens) - i)
            while k < n and edge[k] == tokens[i + k]:
                k += 1
            i += k
            if k < len(edge):
                node = self._split(child, k)
                if i < len(tokens):     # diverging suffix under the split
                    leaf = RadixNode(tokens[i:], len(tokens), node)
                    node.children[tokens[i]] = leaf
                    node = leaf
                    i = len(tokens)
            else:
                node = child
        if node.payload is None:
            node.payload = payload
            node.size = size
            self.total_size += size
            self._num_payloads += 1
            anc = node
            while anc is not None:
                if anc.min_seg is not None and anc.min_seg.end <= node.end:
                    break                   # ancestors above are <= too
                anc.min_seg = node
                anc = anc.parent
        self.touch(node)
        return node

    # ------------------------------------------------------------------
    # pinning / eviction
    # ------------------------------------------------------------------
    def pin(self, node: RadixNode) -> None:
        node.refcount += 1

    def unpin(self, node: RadixNode) -> None:
        if node.refcount <= 0:
            raise ValueError("unpin below zero refcount")
        node.refcount -= 1

    def touch(self, node: RadixNode) -> None:
        """Refresh a node's LRU stamp (matches and publishes do this)."""
        self._clock += 1
        node.last_used = self._clock

    def payload_nodes(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.payload is not None:
                out.append(n)
            stack.extend(n.children.values())
        return out

    @property
    def num_payloads(self) -> int:
        return self._num_payloads

    @staticmethod
    def _has_payload_desc(node: RadixNode) -> bool:
        # a child's min_seg is non-None iff its subtree holds a payload
        return any(c.min_seg is not None for c in node.children.values())

    @staticmethod
    def _recompute_min_seg_up(node: Optional[RadixNode]) -> None:
        """Recompute ``min_seg`` from ``node`` to the root after a
        payload removal (O(depth x branching))."""
        while node is not None:
            cands = [c.min_seg for c in node.children.values()
                     if c.min_seg is not None]
            if node.payload is not None:
                cands.append(node)
            node.min_seg = min(cands, key=lambda n: n.end) \
                if cands else None
            node = node.parent

    def _payload_leaves(self) -> List[RadixNode]:
        """Payload nodes with no payload-bearing descendant — the only
        evictable nodes (inner prefixes are shared by more prompts)."""
        return [n for n in self.payload_nodes()
                if not self._has_payload_desc(n)]

    def _prune(self, node: RadixNode) -> None:
        """Detach payload-less childless chains after an eviction so
        tree paths always end in (or lead to) live payloads."""
        while node is not None and node.parent is not None \
                and node.payload is None and not node.children \
                and node.refcount == 0:
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    def evict(self, budget: int) -> List[RadixNode]:
        """Drop LRU unpinned payload-leaves until ``total_size <=
        budget``.  Pinned segments are never evicted (the budget may
        therefore be temporarily exceeded).  Returns the evicted nodes.

        The candidate set is computed once and maintained incrementally
        — evicting a leaf can only newly expose its nearest payload
        ancestor, so each eviction does one localized leaf-check
        instead of re-scanning every payload subtree (O(n^2) on a
        production-sized cache)."""
        evicted: List[RadixNode] = []
        if self.total_size <= budget:
            return evicted
        heap = [(n.last_used, id(n), n) for n in self._payload_leaves()
                if n.refcount == 0]
        heapq.heapify(heap)
        while self.total_size > budget and heap:
            _, _, victim = heapq.heappop(heap)
            self.total_size -= victim.size
            victim.payload = None
            victim.size = 0
            self._num_payloads -= 1
            evicted.append(victim)
            self._prune(victim)
            self._recompute_min_seg_up(victim)
            anc = victim.parent
            while anc is not None and anc.payload is None:
                anc = anc.parent
            if anc is not None and anc.refcount == 0 \
                    and not self._has_payload_desc(anc):
                heapq.heappush(heap, (anc.last_used, id(anc), anc))
        return evicted


class PrefixCache:
    """Engine-facing prefix cache over a :class:`SlotKVPool`.

    ``chunk`` quantizes physical segment lengths (and is the engine's
    prefill-chunk size, so the copied tail past a match is overwritten by
    the first suffix chunk before it can be attended).
    ``capacity_tokens`` bounds the cached physical tokens (0 =
    unbounded); eviction runs after each publish.  ``stats_fn`` returns
    the engine's live :class:`EngineStats` (a caller may swap the
    engine's stats object between runs, so the cache must not capture
    one instance); ``obs_fn`` its ``Telemetry``."""

    def __init__(self, pool, chunk: int, capacity_tokens: int = 0,
                 stats_fn: Optional[Callable] = None,
                 obs_fn: Optional[Callable] = None):
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if capacity_tokens < 0:
            raise ValueError(
                f"capacity_tokens must be >= 0, got {capacity_tokens}")
        if not pool.can_cache_prefix:
            raise ValueError(
                "prefix caching needs full-length self-attention caches; "
                "rolling-window and SSM cache layouts cannot slice a "
                "prefix by position")
        self.pool = pool
        self.chunk = chunk
        self.capacity_tokens = capacity_tokens
        self.tree = RadixTree()
        self._stats_fn = stats_fn
        self._obs_fn = obs_fn
        self._pins: Dict[int, RadixNode] = {}   # request_id -> source node

    # ------------------------------------------------------------------
    def _phys(self, n: int) -> int:
        """Quantize a logical prefix length up to a chunk multiple."""
        return -(-n // self.chunk) * self.chunk

    def _stats(self):
        return self._stats_fn() if self._stats_fn is not None else None

    def _obs(self):
        return self._obs_fn() if self._obs_fn is not None else None

    @property
    def cached_tokens(self) -> int:
        return self.tree.total_size

    @property
    def num_segments(self) -> int:
        return self.tree.num_payloads

    def lookup(self, prompt) -> int:
        """Matched prefix length a request with this prompt would reuse.
        A pure read (no copy, no stats, no LRU refresh — observing the
        cache must not change what gets evicted)."""
        _, n = self.tree.match(tuple(int(t) for t in prompt),
                               limit=len(prompt) - 1, touch=False)
        return n

    # ------------------------------------------------------------------
    def admit(self, rs) -> int:
        """Consult the cache for ``rs`` (slot already allocated): on a
        hit, copy the matched segment into the request's slot at offset 0
        and advance its prefill cursor so only the un-cached suffix is
        chunk-prefilled.  Pins the source node until :meth:`publish`.
        Returns the matched length (0 = miss)."""
        stats = self._stats()
        tele = self._obs()
        if stats is not None:
            stats.prefix_lookups += 1
        t0 = _obs_now() if tele is not None and tele.tracer is not None \
            else None
        prompt = tuple(int(t) for t in rs.request.prompt)
        src, n = self.tree.match(prompt, limit=len(prompt) - 1)
        hit = src is not None and n > 0
        if hit:
            # the whole physical segment is copied; only the matched
            # [0, n) prefix is live — the copied tail is overwritten or
            # masked before anything can attend it
            ctx = tele.annotate("repro/prefix_write") if tele is not None \
                else NULL_CONTEXT
            with ctx:
                self.pool.write_prefix(src.payload, rs.slot)
            self.pool.lengths[rs.slot] = n
            rs.next_offset = n
            self.tree.pin(src)
            self._pins[rs.request.request_id] = src
            if stats is not None:
                stats.prefix_hits += 1
                stats.prefix_tokens_saved += n
                stats.prefix_hit_len.append(n)
        if t0 is not None:
            tele.tracer.complete(
                "prefix_lookup", t0, _obs_now(),
                tid=rs.request.request_id + 1, slot=rs.slot, hit=hit,
                matched=n if hit else 0)
        return n if hit else 0

    def release(self, rs) -> None:
        """Unpin the source node ``rs`` admitted against, if any."""
        node = self._pins.pop(rs.request.request_id, None)
        if node is not None:
            self.tree.unpin(node)

    def publish(self, rs) -> None:
        """Called by the engine when ``rs`` finishes prefill: release
        the admission pin and cache the slot's whole prompt prefix
        ``[0, P)`` (skipped when an identical prefix is already cached —
        prefix-deterministic prefill makes segments content-unique), then
        evict down to the token budget."""
        self.release(rs)
        prompt = tuple(int(t) for t in rs.request.prompt)
        existing = self.tree.covered(prompt)
        if existing is not None:
            self.tree.touch(existing)
            return
        phys = self._phys(len(prompt))
        tele = self._obs()
        ctx = tele.annotate("repro/prefix_extract") if tele is not None \
            else NULL_CONTEXT
        with ctx:
            seg = self.pool.extract_prefix(rs.slot, phys)
        self.tree.insert(prompt, seg, phys)
        if self.capacity_tokens:
            before = self.tree.total_size   # evict() zeroes victim sizes
            evicted = self.tree.evict(self.capacity_tokens)
            stats = self._stats()
            if stats is not None:
                stats.prefix_evicted_segments += len(evicted)
            if evicted and tele is not None and tele.events is not None:
                tele.events.emit(
                    "prefix_evict", segments=len(evicted),
                    tokens=before - self.tree.total_size,
                    depths=[n.end for n in evicted],
                    cached_tokens=self.tree.total_size,
                    trigger_request=rs.request.request_id)
            if evicted and tele is not None and tele.flight is not None:
                tele.flight.decision(
                    "prefix_evict", segments=len(evicted),
                    tokens=before - self.tree.total_size,
                    cached_tokens=self.tree.total_size,
                    trigger_request=rs.request.request_id)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The prefix-cache fields of the reference engine's snapshot."""
        stats = self._stats()
        out = {
            "prefix_cached_tokens": self.cached_tokens,
            "prefix_segments": self.num_segments,
        }
        if stats is not None:
            out["prefix_hit_rate"] = round(
                stats.prefix_hits / stats.prefix_lookups, 4) \
                if stats.prefix_lookups else None
            out["prefix_tokens_saved"] = stats.prefix_tokens_saved
        return out
