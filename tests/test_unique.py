"""distribute_keys vs a transcription of MeshBufferContainer.cs:154-169."""
import jax.numpy as jnp
import numpy as np
import pytest

from unitysimpleraytracing.ops.unique import distribute_keys
from unitysimpleraytracing.utils import validate


def distribute_keys_scalar(keys: np.ndarray, n: int) -> np.ndarray:
    out = keys.copy()
    new_cur = np.uint32(0)
    old_cur = out[0]
    out[0] = new_cur
    for i in range(1, n):
        new_cur = np.uint32(new_cur + max(np.uint32(out[i] - old_cur), np.uint32(1)))
        old_cur = out[i]
        out[i] = new_cur
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_reference_scalar(seed):
    rng = np.random.default_rng(seed)
    n = 777
    keys = np.sort(rng.integers(0, 1 << 30, size=1024).astype(np.uint32))
    got = np.asarray(distribute_keys(jnp.asarray(keys), n))
    want = distribute_keys_scalar(keys, n)
    np.testing.assert_array_equal(got, want)


def test_all_equal_keys_become_iota():
    keys = np.zeros(512, np.uint32)
    got = np.asarray(distribute_keys(jnp.asarray(keys), 512))
    np.testing.assert_array_equal(got, np.arange(512, dtype=np.uint32))


def test_strictly_increasing_and_padding_untouched():
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 1 << 30, size=1024).astype(np.uint32))
    keys[900:] = 0xFFFFFFFF
    got = np.asarray(distribute_keys(jnp.asarray(keys), 900))
    validate.check_unique_strictly_increasing(got, 900)
    assert np.all(got[900:] == 0xFFFFFFFF)


def test_already_unique_keys_preserve_gaps():
    keys = np.array([3, 10, 11, 50], np.uint32)
    got = np.asarray(distribute_keys(jnp.asarray(keys), 4))
    np.testing.assert_array_equal(got, np.array([0, 7, 8, 47], np.uint32))
