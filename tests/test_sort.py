"""Sort primitive: stability, permutation, padding behavior — the promoted
versions of ComputeBufferSorter.cs's inline validators (SURVEY §4.1)."""
import jax.numpy as jnp
import numpy as np
import pytest

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.ops import sort
from unitysimpleraytracing.utils import validate

IMPLS = ["xla", "packed", "lex2", "radix"]


def _random_kv(n, seed=0, key_bits=32):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**key_bits, size=n, dtype=np.uint64).astype(np.uint32)
    values = np.arange(n, dtype=np.int32)
    return keys, values


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_sort_matches_stable_oracle(impl, n):
    keys, values = _random_kv(n, seed=n)
    ko, vo = sort.sort_key_val(jnp.asarray(keys), jnp.asarray(values), impl=impl)
    validate.check_sorted(ko, n)
    validate.check_permutation(keys, ko, n)
    validate.check_stability(keys, values, ko, vo, n)


@pytest.mark.parametrize("impl", IMPLS)
def test_sort_with_heavy_duplicates(impl):
    # 30-bit Morton codes of a clustered scene: few distinct values.
    rng = np.random.default_rng(7)
    keys = rng.choice([0, 1, 5, 1 << 29, (1 << 30) - 1], size=4096).astype(np.uint32)
    values = np.arange(4096, dtype=np.int32)
    ko, vo = sort.sort_key_val(jnp.asarray(keys), jnp.asarray(values), impl=impl)
    validate.check_stability(keys, values, ko, vo, 4096)


@pytest.mark.parametrize("impl", IMPLS)
def test_padding_keys_sort_to_tail(impl):
    # Padding = 0xFFFFFFFF must land at the end (MeshBufferContainer.cs:108).
    n, real = 1024, 700
    keys = np.full(n, C.KEY_PADDING, np.uint32)
    rng = np.random.default_rng(3)
    keys[:real] = rng.integers(0, 1 << 30, size=real).astype(np.uint32)
    values = np.arange(n, dtype=np.int32)
    ko, _ = sort.sort_key_val(jnp.asarray(keys), jnp.asarray(values), impl=impl)
    ko = np.asarray(ko)
    assert np.all(ko[real:] == C.KEY_PADDING)
    assert np.all(ko[:real] < C.KEY_PADDING)


def test_radix_sort_single_block_and_multi_block_agree():
    keys, values = _random_kv(8192, seed=11)
    k1, v1 = sort.radix_sort_key_val(jnp.asarray(keys), jnp.asarray(values), block=8192)
    k2, v2 = sort.radix_sort_key_val(jnp.asarray(keys), jnp.asarray(values), block=1024)
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_argsort_by_key():
    keys, _ = _random_kv(2048, seed=5)
    perm = np.asarray(sort.argsort_by_key(jnp.asarray(keys)))
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("impl", ["radix"])
def test_per_pass_validation_clean(impl):
    """validate_sort_per_pass drives every digit pass standalone and checks
    the reference's in-situ per-pass invariants (ComputeBufferSorter.cs:
    107-125, 193-271) — clean engines pass."""
    keys, values = _random_kv(4096, seed=7)
    validate.validate_sort_per_pass(jnp.asarray(keys), jnp.asarray(values), impl=impl)


def test_per_pass_validation_catches_corruption():
    """A corrupted pass is caught by the per-pass checks: a scan off-by-one
    breaks the recurrence, a swapped key breaks the digit histogram, and an
    unstable tie order breaks the stable-digit contract."""
    keys, values = _random_kv(2048, seed=3)
    k, v = jnp.asarray(keys), jnp.asarray(values)
    ko, vo, hist_t, scanned = sort.radix_pass_debug(k, v, 0)
    # Clean pass validates.
    validate.validate_sort_pass(k, v, ko, vo, hist_t, scanned, 0, 2048)
    # (a) scan recurrence corruption.
    bad_scan = np.asarray(scanned).copy()
    bad_scan[100] += 1
    with pytest.raises(AssertionError):
        validate.validate_sort_pass(k, v, ko, vo, hist_t, bad_scan, 0, 2048)
    # (b) output key corruption (digit histogram diff).
    bad_keys = np.asarray(ko).copy()
    bad_keys[5] ^= 0xFF
    with pytest.raises(AssertionError):
        validate.check_digit_histogram(np.asarray(k), bad_keys, 0)
    # (c) engine-histogram corruption vs host recount.
    bad_hist = np.asarray(hist_t).copy()
    bad_hist[0] += 1
    with pytest.raises(AssertionError):
        validate.check_block_histograms(np.asarray(k), bad_hist, 0, 2048)
    # (d) stability violation: swap two equal-digit values.
    d = (keys >> np.uint32(0)) & np.uint32(255)
    b = np.argsort(d, kind="stable")
    # find two adjacent outputs with equal digit and swap their values
    ds = d[b]
    eq = np.nonzero(ds[1:] == ds[:-1])[0]
    assert eq.size > 0
    i = int(eq[0])
    bad_vals = np.asarray(vo).copy()
    bad_vals[i], bad_vals[i + 1] = bad_vals[i + 1], bad_vals[i]
    with pytest.raises(AssertionError):
        validate.check_pass_stable(np.asarray(k), np.asarray(v), np.asarray(ko), bad_vals, 0)


@pytest.mark.parametrize("impl", ["radix"])
def test_per_pass_validation_padded_sizes(impl):
    """Capacity-padded scene arrays are not block multiples (e.g. 7168 with
    SORT_BLOCK=4096) — the per-pass validator pads with tail-sorting max
    keys like the reference (MeshBufferContainer.cs:108-109)."""
    keys, values = _random_kv(7168, seed=5)
    validate.validate_sort_per_pass(jnp.asarray(keys), jnp.asarray(values), impl=impl)
