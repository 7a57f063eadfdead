"""The hashing plane and the coalescing proof server (the port of the JAX
package's ``proofserve/``).

  * ``plane``   the hashing front door of the type layer: the SHA-256 tree
    kernel (``ops/sha256_tree``) or the serial host reference,
    bit-identically, behind the ``COMETBFT_TPU_PROOFSERVE`` kill switch
    and a min-batch gate;
  * ``service`` the proof-query coalescer (bounded queue, one tree build
    per (kind, height) group, LRU cache) for ``tx(prove=True)``, header
    and validator-hash queries;
  * ``stats``   the process-wide counters.

Importing the package imports no torch: the plane imports the tree module
only for a tree past its size gate.
"""

from cometbft_tpu_torch.proofserve import plane, service, stats  # noqa: F401
from cometbft_tpu_torch.proofserve.plane import (  # noqa: F401
    enabled,
    tree_hash,
    tree_proofs,
)
from cometbft_tpu_torch.proofserve.service import (  # noqa: F401
    ProofServer,
    QueueFullError,
    ServerStoppedError,
    configure,
    get_server,
    prove_tx,
    reset_server,
    server_active,
)
