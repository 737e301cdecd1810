"""Native C++ OBJ loader vs the pure-Python parser (bit-identical contract)."""
import os

import numpy as np
import pytest

from unitysimpleraytracing import native
from unitysimpleraytracing.core import mesh

OBJS = [
    "/root/reference/Assets/_Assets/Diagoanl object.obj",
    "/root/reference/Assets/_Assets/viking_room.obj",
]

needs_native = pytest.mark.skipif(
    not native.available(), reason=f"native build unavailable: {native.build_error()}"
)


@needs_native
@pytest.mark.parametrize("path", OBJS)
@pytest.mark.parametrize("flip_x", [False, True])
def test_native_matches_python(path, flip_x):
    import os

    if not os.path.exists(path):
        pytest.skip("reference asset not present")
    a = mesh.load_obj(path, backend="python", flip_x=flip_x)
    b = mesh.load_obj(path, backend="native", flip_x=flip_x)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.uvs, b.uvs)
    np.testing.assert_array_equal(a.normals, b.normals)


@needs_native
def test_native_polygon_fan_and_negative_indices(tmp_path):
    # Quad + negative-relative indices + missing vt/vn components.
    p = tmp_path / "t.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n"
        "f -4 -3 -2\n"
    )
    a = mesh.load_obj(str(p), backend="python")
    b = mesh.load_obj(str(p), backend="native")
    assert b.num_triangles == 3  # quad fan (2) + tri (1)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.uvs, b.uvs)


@needs_native
def test_native_missing_file_raises():
    with pytest.raises(RuntimeError):
        native.load_obj_native("/nonexistent/file.obj")


@needs_native
def test_native_png_unfilter_matches_pure(tmp_path):
    """C++ PNG unfilter (native/image.cpp) is bit-identical to the Python
    loops across all filter types (the reference texture uses 1-4)."""
    import unitysimpleraytracing.native as N
    from unitysimpleraytracing.io import png as P

    src = "/root/reference/Assets/_Assets/viking_room.png"
    if not os.path.exists(src):
        pytest.skip("reference texture not present")
    a = P._read_png_pure(src)
    orig = N.png_unfilter_native
    N.png_unfilter_native = lambda *args: (_ for _ in ()).throw(RuntimeError)
    try:
        b = P._read_png_pure(src)
    finally:
        N.png_unfilter_native = orig
    np.testing.assert_array_equal(a, b)
