"""The transport plane's front door: coalesced AEAD frames for p2p streams.

Counterpart of the JAX package's ``p2p/transportplane.py``.
``SecretConnection`` routes every batched seal and open through this
module, the one seam between the wire format and the batched AEAD
(``ops/chacha_aead``).  The plane owns the nonce convention (CometBFT's
little-endian 64-bit counter in a 96-bit nonce) and the batch/serial
routing:

  * ``batch_active(n)``: ``COMETBFT_TPU_AEAD`` is not 0 (default on) and
    ``n`` reaches ``COMETBFT_TPU_AEAD_MIN_BATCH`` (default 4).  Below it
    the caller keeps its per-frame serial path (``aead_ref``), the same
    bytes; ``COMETBFT_TPU_AEAD=0`` restores the serial path everywhere;
  * ``seal_frames(key, nonce_start, payloads)``: one pass over
    consecutive nonces; frame i equals
    ``ChaCha20Poly1305Ref.encrypt(nonce(nonce_start + i), payload, b"")``;
  * ``open_frames(key, nonce_start, sealed)``: one pass; the plaintext
    prefix up to (not including) the first authentication failure, and
    that failure's index, so the caller delivers exactly what the serial
    loop would have delivered before raising.

``device`` (None: the card, by the gate) goes down to ``ops/chacha_aead``;
on a card a pass the kernel did not serve raises ``BackendError``.  Each
pass records an ``aead.flush`` span (``libs/tracing``), as in the JAX
package.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Sequence

from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.ops import chacha_aead
from cometbft_tpu_torch.p2p import transport_stats as tstats

DEFAULT_MIN_BATCH = 4


def enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_AEAD", "1") != "0"


def min_batch() -> int:
    try:
        return max(int(os.environ.get("COMETBFT_TPU_AEAD_MIN_BATCH", "")
                       or DEFAULT_MIN_BATCH), 1)
    except ValueError:
        return DEFAULT_MIN_BATCH


def batch_active(n: int) -> bool:
    """Route ``n`` pending frames through the coalesced plane?  Singles
    and small batches stay on the serial path: below the floor there is
    nothing to amortize."""
    return enabled() and n >= min_batch()


def nonce_bytes(counter: int) -> bytes:
    """CometBFT's SecretConnection nonce: LE64 counter + 4 zero bytes."""
    return struct.pack("<Q", counter) + b"\x00\x00\x00\x00"


def seal_frames(key: bytes, nonce_start: int, payloads: "Sequence[bytes]",
                device=None) -> "list[bytes]":
    """One coalesced seal over ``payloads`` at nonces ``nonce_start..``;
    ``ciphertext || tag`` per frame, equal to the serial reference."""
    frames = [(key, nonce_bytes(nonce_start + i), bytes(p))
              for i, p in enumerate(payloads)]
    with tracing.span("aead.flush", op="seal", frames=len(frames)):
        tstats.record_batch("seal")
        tstats.record_frames("batched", len(frames))
        return chacha_aead.seal_frames(frames, device)


def open_frames(key: bytes, nonce_start: int, sealed: "Sequence[bytes]",
                device=None) -> "tuple[list[bytes], Optional[int]]":
    """One coalesced verify and decrypt over ``sealed`` at consecutive
    nonces.  Returns ``(plaintexts, bad_index)``: every frame before
    ``bad_index`` authenticated and is delivered; ``bad_index`` is the
    first authentication failure (None when all verified).  Frames after
    a failure are withheld even if they verified: the serial loop would
    never have reached them."""
    frames = [(key, nonce_bytes(nonce_start + i), bytes(c))
              for i, c in enumerate(sealed)]
    with tracing.span("aead.flush", op="open", frames=len(frames)):
        tstats.record_batch("open")
        tstats.record_frames("batched", len(frames))
        pts = chacha_aead.open_frames(frames, device)
    out: "list[bytes]" = []
    for i, p in enumerate(pts):
        if p is None:
            return out, i
        out.append(p)
    return out, None


def record_serial_frames(n: int) -> None:
    """Accounting of the frames a caller sealed or opened serially."""
    tstats.record_frames("serial", n)
