"""Morton encoding vs a scalar transcription of MeshBufferContainer.cs:32-50."""
import numpy as np

from unitysimpleraytracing.core import morton


def expand_bits_scalar(v: int) -> int:
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v & 0xFFFFFFFF


def morton3d_scalar(x: float, y: float, z: float) -> int:
    def q(f):
        return int(min(max(f * 1024.0, 0.0), 1023.0))

    return expand_bits_scalar(q(x)) * 4 + expand_bits_scalar(q(y)) * 2 + expand_bits_scalar(q(z))


def test_expand_bits_matches_scalar():
    vals = np.arange(1024, dtype=np.uint32)
    got = np.asarray(morton.expand_bits(vals))
    want = np.array([expand_bits_scalar(int(v)) for v in vals], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_morton3d_matches_scalar():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.2, 1.2, size=(500, 3)).astype(np.float32)  # incl. clamps
    got = np.asarray(morton.morton_from_points(pts))
    want = np.array(
        [morton3d_scalar(float(p[0]), float(p[1]), float(p[2])) for p in pts],
        np.uint32,
    )
    np.testing.assert_array_equal(got, want)


def test_morton_is_30bit():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1, size=(1000, 3)).astype(np.float32)
    got = np.asarray(morton.morton_from_points(pts))
    assert np.all(got < (1 << 30))
