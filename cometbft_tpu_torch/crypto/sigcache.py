"""Consensus-wide signature verification cache.

A bounded, thread-safe LRU mapping SHA-256(pub ‖ msg ‖ sig) -> bool: the
port's copy of ``cometbft_tpu/crypto/sigcache.py``.  A node verifies every
vote signature at gossip time, and the same signature again when the
commit built from those votes is checked at apply time, when blocksync
re-checks a served commit and when the light client syncs.  Caching the
verdict makes those re-verifications near-free and lets the batch
verifiers (``crypto/batch.py``) ship only cache MISSES to the card: a
commit whose votes were all verified before makes no kernel launch.

Key safety:
  * the key digests the FULL (pub, msg, sig) triple with length framing, so
    two distinct triples can never alias short of a SHA-256 collision;
  * signature verification is a pure function of the triple — in particular
    an *invalid* triple is invalid forever, so negative caching is safe;
  * a wrong *prediction* (e.g. a prefetch against a stale validator set)
    caches a verdict for a triple that is simply never queried — it can
    waste a slot, never corrupt an answer;
  * verdicts are implementation-independent: the kernel, its plain version
    and the host oracle are all ZIP-215 and are held to each other by the
    tests, so it does not matter WHICH verifier produced a cached bit;
  * only definitive verdicts are cached (``writeback``): an infrastructure
    failure raises and leaves the cache as it was.

Kill-switch: ``COMETBFT_TPU_SIGCACHE=0`` disables lookups AND inserts,
restoring the uncached behavior exactly.  ``COMETBFT_TPU_SIGCACHE_SIZE``
bounds the entry count (default 65536; ~48 B of digest+flag per entry plus
dict overhead keeps the default well under 10 MB).  Both are the JAX
package's variables, read the same way.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional

DEFAULT_CAPACITY = 65536


def _key(pub: bytes, msg: bytes, sig: bytes) -> bytes:
    h = hashlib.sha256()
    # length framing: (pub, msg, sig) concatenations can otherwise alias
    # across entries with variable-length msgs
    h.update(len(pub).to_bytes(4, "little"))
    h.update(pub)
    h.update(len(msg).to_bytes(4, "little"))
    h.update(msg)
    h.update(sig)
    return h.digest()


class SigCache:
    """LRU over verification verdicts; all methods are thread-safe."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, bool]" = OrderedDict()
        self._hits = 0
        self._misses = 0

    @staticmethod
    def enabled() -> bool:
        return os.environ.get("COMETBFT_TPU_SIGCACHE", "1") != "0"

    def get(self, pub: bytes, msg: bytes, sig: bytes) -> Optional[bool]:
        """Cached verdict or None.  Disabled cache always misses (without
        counting: the stats then honestly read as all-miss-no-traffic)."""
        if not self.enabled():
            return None
        return self._get(_key(pub, msg, sig))

    def _get(self, k: bytes) -> Optional[bool]:
        """Lookup past the kill-switch check — batch callers
        (``partition_misses``) hoist ``enabled()`` to once per batch; a
        10k-signature commit must not pay an os.environ read per entry."""
        with self._lock:
            v = self._entries.get(k)
            if v is None:
                self._misses += 1
                return None
            self._entries.move_to_end(k)
            self._hits += 1
            return v

    def put(self, pub: bytes, msg: bytes, sig: bytes, ok: bool) -> None:
        if not self.enabled():
            return
        self._put(_key(pub, msg, sig), ok)

    def _put(self, k: bytes, ok: bool) -> None:
        with self._lock:
            self._entries[k] = bool(ok)
            self._entries.move_to_end(k)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = 0
            self._misses = 0

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self._hits, self._misses
            size = len(self._entries)
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "size": size,
            "capacity": self.capacity,
            "hit_rate": (hits / total) if total else 0.0,
        }


_CACHE: Optional[SigCache] = None
_CACHE_LOCK = threading.Lock()


def get_cache() -> SigCache:
    """The process-wide cache (every verifier of the process shares one —
    that sharing IS the optimization)."""
    global _CACHE
    if _CACHE is None:
        with _CACHE_LOCK:
            if _CACHE is None:
                cap = int(
                    os.environ.get(
                        "COMETBFT_TPU_SIGCACHE_SIZE", str(DEFAULT_CAPACITY)
                    )
                )
                _CACHE = SigCache(cap)
    return _CACHE


def reset_cache() -> None:
    """Drop the process-wide cache (tests; also re-reads the size env)."""
    global _CACHE
    with _CACHE_LOCK:
        _CACHE = None


def partition_misses(
    pubs,
    msgs,
    sigs,
    pub_sizes: tuple = (32,),
    sig_sizes: tuple = (64,),
):
    """THE cache/structural prefilter, shared by every consumer (the batch
    verifiers now; blocksync's window prefetch and the light client's
    chain sync once they are ported) so the size rules and get/put
    protocol cannot diverge.

    Returns (bits, miss_indices): ``bits[i]`` is the resolved verdict —
    False for structurally impossible pub/sig lengths (they must never
    occupy backend lanes), the cached verdict on a hit — or None for the
    entries listed in ``miss_indices``, which the caller verifies and
    feeds to ``writeback``.  Empty ``pub_sizes``/``sig_sizes`` disable
    that structural filter."""
    cache = get_cache()
    enabled = cache.enabled()  # hoisted: one env read per batch, not per sig
    bits: list = [None] * len(pubs)
    miss: list = []
    for i, (p, m, s) in enumerate(zip(pubs, msgs, sigs)):
        if (pub_sizes and len(p) not in pub_sizes) or (
            sig_sizes and len(s) not in sig_sizes
        ):
            bits[i] = False
            continue
        hit = cache._get(_key(p, m, s)) if enabled else None
        if hit is not None:
            bits[i] = hit
            continue
        miss.append(i)
    return bits, miss


def writeback(pubs, msgs, sigs, bits, miss_indices, results) -> None:
    """Resolve ``partition_misses``'s holes: record each fresh verdict in
    ``bits`` and in the cache (``results`` aligns with ``miss_indices``).

    Only DEFINITIVE verdicts are cached: a ``None`` result marks an entry
    the backend could not judge (an infrastructure failure).  Caching
    ``False`` for it would negative-cache a possibly-valid signature
    forever, so the hole is left in ``bits`` for the caller to surface as
    an error, never as a verdict."""
    cache = get_cache()
    enabled = cache.enabled()  # hoisted: one env read per batch, not per sig
    for i, r in zip(miss_indices, results):
        if r is None:
            continue
        r = bool(r)
        bits[i] = r
        if enabled:
            cache._put(_key(pubs[i], msgs[i], sigs[i]), r)


def verify_with_cache(pub_key, msg: bytes, sig: bytes) -> bool:
    """Single-signature verification through the cache: the drop-in for
    ``pub_key.verify_signature(msg, sig)`` on consensus paths (vote,
    proposal, vote-extension checks)."""
    pub = pub_key.bytes() if hasattr(pub_key, "bytes") else bytes(pub_key)
    cache = get_cache()
    hit = cache.get(pub, msg, sig)
    if hit is not None:
        return hit
    ok = bool(pub_key.verify_signature(msg, sig))
    cache.put(pub, msg, sig, ok)
    return ok
