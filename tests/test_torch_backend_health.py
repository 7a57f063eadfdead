"""The port's circuit breakers and health registry
(``cometbft_tpu_torch/crypto/backend_health.py``) against the JAX
package's: one seeded event sequence, driven on both under one fake
clock, gives the same breaker states and ``stats()`` after every event,
and the same registry snapshot at the end.
"""

import numpy as np
import pytest

from cometbft_tpu.crypto import backend_health as jbh
from cometbft_tpu_torch.crypto import backend_health as tbh


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


EVENTS = ("allow", "success", "failure", "trip", "advance", "demotion",
          "watchdog", "fallback", "quarantine")


def _drive(mod, seed: int, names=("cuda", "torch")):
    """Apply the seed's event sequence to a fresh registry of ``mod``;
    returns the observations after every event and the final snapshot."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    reg = mod.HealthRegistry(clock=clk)
    log = []
    for _ in range(120):
        ev = EVENTS[int(rng.integers(0, len(EVENTS)))]
        name = names[int(rng.integers(0, len(names)))]
        br = reg.breaker(name)
        got = None
        if ev == "allow":
            got = br.allow()
        elif ev == "success":
            br.record_success()
        elif ev == "failure":
            br.record_failure(RuntimeError("x"))
        elif ev == "trip":
            br.trip("probe down")
        elif ev == "advance":
            clk.advance(float(rng.choice([0.1, 0.6, 1.2, 2.5, 9.0])))
        elif ev == "demotion":
            reg.record_demotion(name)
        elif ev == "watchdog":
            reg.record_watchdog_fire(name)
        elif ev == "fallback":
            reg.record_fallback(int(rng.integers(1, 50)))
        else:
            reg.record_quarantine(name)
        log.append((ev, name, got, br.state, br.stats()))
    return log, reg.snapshot()


@pytest.mark.parametrize("seed", range(6))
def test_event_sequence_matches_jax(seed, monkeypatch):
    monkeypatch.setenv("COMETBFT_TPU_BREAKER_THRESHOLD", str(1 + seed % 3))
    monkeypatch.setenv("COMETBFT_TPU_BREAKER_BACKOFF_MS", "500")
    monkeypatch.setenv("COMETBFT_TPU_BREAKER_BACKOFF_MAX_MS", "4000")
    want_log, want_snap = _drive(jbh, seed)
    got_log, got_snap = _drive(tbh, seed)
    for step, (w, g) in enumerate(zip(want_log, got_log)):
        assert g == w, f"step {step}"
    assert got_snap == want_snap
    assert {s["state"] for s in got_snap["breakers"].values()} <= {
        tbh.CLOSED, tbh.OPEN, tbh.HALF_OPEN}


def test_half_open_probe_cycle_and_capped_backoff():
    """The state machine of the module docstring, step by step."""
    clk = FakeClock()
    br = tbh.CircuitBreaker("t", threshold=2, backoff_s=1.0,
                            backoff_max_s=3.0, clock=clk)
    br.record_failure()
    assert br.state == tbh.CLOSED and br.allow()
    br.record_failure()
    assert br.state == tbh.OPEN and not br.allow()
    clk.advance(1.01)
    assert br.state == tbh.HALF_OPEN
    assert br.allow() and not br.allow()  # one probe per window
    br.record_failure()  # the probe failed: open for 2.0, next 3.0 (cap)
    clk.advance(1.5)
    assert not br.allow()
    clk.advance(0.6)
    assert br.allow()
    br.record_success()
    st = br.stats()
    assert (br.state, st["repromotions"], st["backoff_s"], st["probes"]) == (
        tbh.CLOSED, 1, 1.0, 2)


def test_module_registry_reset_and_errors():
    tbh.reset()
    reg = tbh.registry()
    assert tbh.registry() is reg
    reg.breaker("cuda").trip("down")
    reg.record_demotion("cuda")
    snap = tbh.snapshot()
    assert snap["open_breakers"] == 1 and snap["demotions"] == 1
    tbh.reset()
    assert tbh.registry() is not reg and tbh.snapshot()["breakers"] == {}
    assert issubclass(tbh.DispatchTimeoutError, tbh.BackendError)
    assert issubclass(tbh.BackendOutputError, tbh.BackendError)
    assert issubclass(tbh.BackendError, RuntimeError)
