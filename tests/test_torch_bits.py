"""The port's ``libs/bits.BitArray`` held to the JAX package's: every
operation on arrays drawn from one ``random.Random`` seed gives the same
packed bytes (bit ``i`` at ``1 << (i % 8)`` of byte ``i // 8``, the form a
``cometbft.libs.bits.v1.BitArray`` carries) and the same answers, and
``pick_random`` draws the same indices under equal seeds, from the module's
``random`` or from a ``random.Random`` handed to it.  Tolerance: exact
bytes and exact answers throughout.
"""

import random

import pytest

from cometbft_tpu.libs import bits as jbits
from cometbft_tpu_torch.libs import bits as tbits

SEED = 20261023
SIZES = [0, 1, 7, 8, 9, 63, 64, 100]


def _pair(n: int, rng: random.Random):
    bools = [rng.random() < 0.5 for _ in range(n)]
    return jbits.BitArray.from_bools(bools), tbits.BitArray.from_bools(bools)


def _form(ba) -> tuple:
    return ba.bits, bytes(ba._elems)


@pytest.mark.parametrize("n", SIZES)
def test_ops_equal_jax(n):
    rng = random.Random(SEED + n)
    ja, ta = _pair(n, rng)
    jb, tb = _pair(max(n - 3, 0) if n % 2 else n + 5, rng)
    assert _form(ta) == _form(ja)
    for name in ("or_", "and_", "sub"):
        got, want = getattr(ta, name)(tb), getattr(ja, name)(jb)
        assert _form(got) == _form(want), name
        got, want = getattr(tb, name)(ta), getattr(jb, name)(ja)
        assert _form(got) == _form(want), name
    assert _form(ta.not_()) == _form(ja.not_())
    assert _form(ta.copy()) == _form(ja.copy())
    for name in ("is_empty", "is_full", "true_indices", "to_bools", "size", "__str__"):
        assert getattr(ta, name)() == getattr(ja, name)(), name
    for i in (-1, 0, n // 2, n - 1, n, n + 8):
        assert ta.get_index(i) == ja.get_index(i)
        v = rng.random() < 0.5
        assert ta.set_index(i, v) == ja.set_index(i, v)
        assert _form(ta) == _form(ja)
    full_j, full_t = jbits.BitArray.from_bools([True] * n), tbits.BitArray.from_bools([True] * n)
    assert (full_t.is_full(), full_t.is_empty()) == (full_j.is_full(), full_j.is_empty())
    ja.update(jb)
    ta.update(tb)
    assert _form(ta) == _form(ja)


@pytest.mark.parametrize("n", [0, 5, 64, 100])
def test_pick_random_equals_jax_under_equal_seeds(n):
    ja, ta = _pair(n, random.Random(SEED ^ n))
    for seed in (1, 2, 3):
        random.seed(seed)
        want = [ja.pick_random() for _ in range(16)]
        random.seed(seed)
        assert [ta.pick_random() for _ in range(16)] == want
        rng = random.Random(seed)
        assert [ta.pick_random(rng) for _ in range(16)] == want
    if not ja.true_indices():
        assert ta.pick_random(random.Random(0)) is None
