"""cometbft_tpu_torch — the PyTorch + CUDA port of ``cometbft_tpu``.

The package mirrors the JAX package's layout module for module, so each
counterpart is easy to find, and imports nothing of it (nor ``jax``).  Its
hot path is Ed25519 ZIP-215 commit verification:

``types.validation.verify_commit*`` -> ``crypto.batch`` (behind
``crypto.sigcache``) -> ``ops.verify.verify_batch`` (host prep in the C++
host library, ``csrc/host_prep.cpp`` through ``native``) ->
``ops.cuda_verify`` (hand-written CUDA C++ for Hopper,
``csrc/ed25519_verify.cu``).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` or ``backend="cpu"``); with no card and no such request
they raise.  On CPU tensors the kernel's plain PyTorch version
(``ops.verify.verify_core``) runs instead.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
