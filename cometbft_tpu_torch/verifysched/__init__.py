"""Continuous-batching async verification service.

Callers submit signature checks with a priority class and get futures; a
dispatcher thread coalesces pending items across ALL submitters into one
fused ``ops/verify.dispatch_segments`` dispatch under the supervisor
chain.  ``COMETBFT_TPU_VERIFY_SCHED=0`` kills the scheduler and restores
the synchronous per-caller paths.
"""

from cometbft_tpu_torch.verifysched.service import (  # noqa: F401
    DEFAULT_FLUSH_US,
    DEFAULT_QUEUE_CAP,
    PRIO_BLOCKSYNC,
    PRIO_CONSENSUS,
    PRIO_EVIDENCE,
    PRIO_LIGHT,
    PRIO_MEMPOOL,
    QueueFullError,
    VerifyScheduler,
    backend_trusted,
    current_priority,
    enabled,
    gate_device,
    get_scheduler,
    on_gate_device,
    open_gate,
    priority_class,
    reset_scheduler,
    scheduler_active,
    verify_cached,
    verify_many_cached,
    verify_now,
    verify_segment_sync,
)
from cometbft_tpu_torch.verifysched import stats  # noqa: F401
