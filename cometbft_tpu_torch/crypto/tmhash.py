"""SHA-256 helpers (reference: crypto/tmhash/hash.go:22,102)."""

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sum_truncated(data: bytes) -> bytes:
    """First 20 bytes of SHA-256 — used for addresses."""
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
