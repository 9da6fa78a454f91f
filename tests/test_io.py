"""I/O: OBJ/MTL parsing vs known cornell facts, HDR round-trip, PNG round-trip."""

import numpy as np

from tests.conftest import CORNELL_OBJ
from sycl_ray_tracing.utils.hdr import read_hdr, write_hdr
from sycl_ray_tracing.utils.obj_loader import parse_obj
from sycl_ray_tracing.utils.png import read_png, write_png


def test_cornell_parse_counts():
    parsed = parse_obj(CORNELL_OBJ)
    # cornell_box: 16 quads = 32 triangles; 8 MTL materials + debug row
    assert parsed.triangles.shape == (32, 3, 3)
    assert parsed.emission.shape[0] == 9
    assert parsed.material_indices.min() >= 1  # every face has a material
    # the light quad (Ke=50) = 2 triangles
    assert parsed.emissive_indices.shape[0] == 2
    np.testing.assert_allclose(
        parsed.emission[parsed.material_indices[parsed.emissive_indices[0]]],
        [50.0, 50.0, 50.0],
    )


def test_cornell_material_values():
    parsed = parse_obj(CORNELL_OBJ)
    by_name = {n: i for i, n in enumerate(parsed.material_names)}
    left = by_name["leftWall"]
    np.testing.assert_allclose(parsed.diffuse[left], [0.63, 0.065, 0.05])
    # leftWall has Pr 0.0 -> clamped to 1e-2 (utils.cpp:82)
    assert abs(parsed.roughness[left] - 1e-2) < 1e-9
    short_box = by_name["shortBox"]
    assert parsed.metalness[short_box] == 1.0
    # debug material row 0: magenta emission (utils.cpp:75)
    np.testing.assert_allclose(parsed.emission[0], [1.0, 0.0, 1.0])


def test_obj_vertex_values():
    parsed = parse_obj(CORNELL_OBJ)
    # a corner of the short box's top face: (0.53, 0.6, 0.75)
    verts = parsed.triangles.reshape(-1, 3)
    d = np.abs(verts - np.array([0.53, 0.6, 0.75])).sum(axis=1)
    assert d.min() < 1e-6


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.uniform(0, 1, (17, 23, 3)) ** 2 * 40).astype(np.float32)
    p = str(tmp_path / "x.hdr")
    write_hdr(p, img)
    back = read_hdr(p)
    assert back.shape == img.shape
    # RGBE shares one exponent per pixel: error is bounded by one mantissa
    # quantum of the LARGEST channel, so small channels have large *relative*
    # error by design — tolerance is per-pixel absolute
    quantum = img.max(axis=-1, keepdims=True) / 128.0
    assert (np.abs(back - img) <= quantum + 1e-4).all()


def test_hdr_flip_y(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    img[0, 0, 0] = 2.0
    p = str(tmp_path / "f.hdr")
    write_hdr(p, img)
    flipped = read_hdr(p, flip_y=True)
    assert flipped[3, 0, 0] > 1.9


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    write_png(p, img, flip_y=False)
    back = read_png(p)
    expected = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, expected)


def test_png_flip(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    img[0] = 1.0  # bottom row bright
    p = str(tmp_path / "y.png")
    write_png(p, img, flip_y=True)
    back = read_png(p)
    assert back[3].min() == 255  # ends up at the bottom of the PNG raster


def test_bmp_writer(tmp_path):
    from sycl_ray_tracing.utils.png import write_bmp

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (7, 5, 3)).astype(np.float32)
    p = str(tmp_path / "x.bmp")
    write_bmp(p, img, flip_y=False)
    data = open(p, "rb").read()
    assert data[:2] == b"BM"
    import struct
    size, = struct.unpack("<I", data[2:6])
    assert size == len(data)
    w, h = struct.unpack("<ii", data[18:26])
    assert (w, h) == (5, 7)
    # decode the first stored row (bottom row of the image) and compare
    stride = 5 * 3 + ((-(5 * 3)) % 4)
    row0 = np.frombuffer(data[54:54 + 15], np.uint8).reshape(5, 3)[:, ::-1]
    expected = (np.clip(img[6], 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(row0, expected)


def test_read_png_roundtrip(tmp_path):
    """Our PNG reader decodes our PNG writer's output byte-exactly."""
    from sycl_ray_tracing.utils.image_io import read_png
    from sycl_ray_tracing.utils.png import write_png

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = tmp_path / "t.png"
    write_png(str(p), img, flip_y=False)
    back = read_png(str(p))
    np.testing.assert_array_equal(back, img)


def test_read_bmp_roundtrip(tmp_path):
    from sycl_ray_tracing.utils.image_io import read_bmp
    from sycl_ray_tracing.utils.png import write_bmp

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (21, 13, 3), dtype=np.uint8)
    p = tmp_path / "t.bmp"
    write_bmp(str(p), img, flip_y=False)
    back = read_bmp(str(p))
    np.testing.assert_array_equal(back, img)


def test_read_image_float_ldr_semantics(tmp_path):
    """LDR decode is /255 with NO gamma change (image_io.cpp:96-126 —
    the reference leaves linearization as a TODO and ships without it)."""
    from sycl_ray_tracing.utils.image_io import read_image_float
    from sycl_ray_tracing.utils.png import write_png

    img = np.array([[[0, 128, 255]]], dtype=np.uint8)
    p = tmp_path / "t.png"
    write_png(str(p), img, flip_y=False)
    out = read_image_float(str(p))
    np.testing.assert_allclose(out[0, 0], [0.0, 128 / 255, 1.0], atol=1e-7)


def test_read_image_float_hdr_dispatch(tmp_path):
    from sycl_ray_tracing.utils.hdr import write_hdr
    from sycl_ray_tracing.utils.image_io import read_image_float

    rng = np.random.default_rng(7)
    img = (rng.uniform(0, 4, (16, 24, 3))).astype(np.float32)
    p = tmp_path / "t.hdr"
    write_hdr(str(p), img)
    out = read_image_float(str(p))
    # RGBE shares one exponent across channels: absolute error of small
    # channels scales with the pixel's max channel (~1/256 of it)
    np.testing.assert_allclose(out, img, rtol=1e-2, atol=img.max() / 128)


def test_old_style_rle_hdr(tmp_path):
    """Hand-built old-style RLE scanlines (stb semantics: (1,1,1,n)
    repeats the previous pixel, consecutive markers shift the count)."""
    from sycl_ray_tracing.utils.hdr import _rgbe_to_float, read_hdr

    w, h = 12, 2
    # rows of pixels: first pixel literal, then a (1,1,1,11) run marker
    px = np.array([128, 64, 32, 136], np.uint8)  # some RGBE value
    px2 = np.array([20, 200, 90, 135], np.uint8)
    stream = bytes(px) + bytes([1, 1, 1, 11])
    stream += bytes(px2) + bytes([1, 1, 1, 11])
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    p = tmp_path / "old.hdr"
    p.write_bytes(header + stream)
    img = read_hdr(str(p))
    assert img.shape == (h, w, 3)
    want1 = _rgbe_to_float(px[None])[0]
    want2 = _rgbe_to_float(px2[None])[0]
    np.testing.assert_allclose(img[0], np.tile(want1, (w, 1)), rtol=1e-6)
    np.testing.assert_allclose(img[1], np.tile(want2, (w, 1)), rtol=1e-6)
