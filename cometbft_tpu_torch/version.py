"""Version constants (reference: version/version.go:1-18)."""

import os

# Semantic version of this framework.  The env override is the e2e
# binary-upgrade analog: the reference swaps docker images
# (test/e2e/runner/perturb.go:88-131); here the restarted OS process
# reports — and handshakes as — the upgraded version.
__version__ = os.environ.get("COMETBFT_TPU_SEMVER", "0.1.0")
CMT_SEMVER = __version__

# Protocol versions. Block/P2P protocol numbers track the reference so that
# genesis docs and headers carry comparable version metadata.
BLOCK_PROTOCOL = 11
P2P_PROTOCOL = 9
ABCI_SEMVER = "2.2.0"
