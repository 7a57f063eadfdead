"""The hashing front door: route Merkle work to the SHA-256 tree kernel
or the serial host reference, bit-identically (the port of the JAX
package's ``proofserve/plane.py``).

Every hashing call site of the port's types (``types/block.py`` header
and commit hashes, ``types/validator.py`` validator-set hash) goes
through ``tree_hash``, and the proof server (``proofserve/service.py``)
builds a block's proofs through ``tree_proofs``.  The plane then decides
the path:

  * kill switch off (``COMETBFT_TPU_PROOFSERVE=0``) → the serial
    reference, ``crypto/merkle``;
  * small trees (fewer than ``COMETBFT_TPU_MERKLE_MIN_BATCH`` leaves,
    default 32: a 14-field header hash, a small validator set) → the
    reference as well;
  * everything else → ``ops/sha256_tree.tree_root`` (or ``tree_proofs``)
    on ``device``; with
    no device named its gate (the card once the batch seam's self-check
    has passed, never with ``COMETBFT_TPU_CRYPTO_BACKEND=cpu``) picks the
    card or the host.  A hashing call site never runs the self-check, so
    on a machine with no card a validator-set hash keeps working on the
    host.

Imports no torch until a tree passes the size gate.
"""

from __future__ import annotations

import os

from cometbft_tpu_torch.crypto import merkle

DEFAULT_MIN_BATCH = 32


def enabled() -> bool:
    """Kill switch of the plane: ``COMETBFT_TPU_PROOFSERVE=0`` restores the
    serial host path everywhere, bit for bit."""
    return os.environ.get("COMETBFT_TPU_PROOFSERVE", "1") != "0"


def min_batch() -> int:
    try:
        return int(
            os.environ.get("COMETBFT_TPU_MERKLE_MIN_BATCH", "")
            or DEFAULT_MIN_BATCH
        )
    except ValueError:
        return DEFAULT_MIN_BATCH


def tree_hash(items, device=None) -> bytes:
    """Merkle root of ``items``, bit-identical to
    ``merkle.hash_from_byte_slices`` on every path.  ``device`` names the
    tree's device (None: the gate decides)."""
    items = list(items)
    if not enabled() or len(items) < min_batch():
        return merkle.hash_from_byte_slices(items)
    from cometbft_tpu_torch.ops import sha256_tree

    return sha256_tree.tree_root(items, device)


def tree_proofs(items, device=None):
    """(root, [Proof]) of ``items``, bit-identical to
    ``merkle.proofs_from_byte_slices`` on every path.  ``device`` names the
    tree's device (None: the gate decides)."""
    items = list(items)
    if not enabled() or len(items) < min_batch():
        return merkle.proofs_from_byte_slices(items)
    from cometbft_tpu_torch.ops import sha256_tree

    return sha256_tree.tree_proofs(items, device)
