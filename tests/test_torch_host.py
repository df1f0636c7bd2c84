"""The port's own host layer against the JAX package's, bit for bit.

``jincresize_tpu_torch`` keeps copies of ``filters``, ``geometry``,
``operator`` (with the native C++ builder), ``phase``, ``golden``, ``clip``
and ``cache``, so that it imports nothing of the JAX package. The copies
keep the code as it is; these tests hold every array field they produce
equal (values and dtypes) to the originals on periodic, drifted, aperiodic,
cropped, quantised, f64-position, deep-tap and chroma geometries, through
both the native and the NumPy block builders. Each side builds its own
objects: nothing built by one package is passed into the other.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

from jincresize_tpu import cache as jcache
from jincresize_tpu import clip as jclip
from jincresize_tpu import filters as jfilters
from jincresize_tpu import geometry as jgeometry
from jincresize_tpu import golden as jgolden
from jincresize_tpu import native as jnative
from jincresize_tpu import operator as joperator
from jincresize_tpu import phase as jphase
from jincresize_tpu_torch import cache as tcache
from jincresize_tpu_torch import clip as tclip
from jincresize_tpu_torch import filters as tfilters
from jincresize_tpu_torch import geometry as tgeometry
from jincresize_tpu_torch import golden as tgolden
from jincresize_tpu_torch import native as tnative
from jincresize_tpu_torch import operator as toperator
from jincresize_tpu_torch import phase as tphase

# name -> (src_w, src_h, dst_w, dst_h, tap, build_plane_operator kwargs)
GEOMS = {
    "periodic-2x-tap8": (64, 48, 128, 96, 8, {}),
    "drifted-1.5x": (320, 180, 480, 270, 3, {}),
    "aperiodic": (96, 64, 167, 113, 3, {}),
    "crop": (100, 80, 160, 120, 4, {"crop_left": 1.25, "crop_top": 0.5}),
    "quantised-blur": (96, 64, 144, 96, 3, {"quantize_x": 1, "quantize_y": 1, "blur": 0.98}),
    "f64-positions": (128, 96, 192, 144, 4, {"crop_left": 0.123, "crop_top": 0.456, "pos_precision": "f64"}),
    "deep-tap-2x": (480, 270, 240, 135, 16, {}),
    "deep-tap-2/3": (480, 270, 320, 180, 16, {}),
    "chroma-420-topleft": (64, 48, 128, 96, 3, {"cplace": "topleft"}),
}  # fmt: skip


def assert_same(a, b, path="value"):
    """Equal structure, equal scalars, and arrays equal in values and dtype."""
    assert type(a).__name__ == type(b).__name__, path
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


@contextlib.contextmanager
def numpy_builder(native_mod):
    """Run ``native_mod``'s package on its NumPy block builder."""
    saved = native_mod._LIB, native_mod._TRIED
    native_mod._LIB, native_mod._TRIED = None, True
    try:
        yield
    finally:
        native_mod._LIB, native_mod._TRIED = saved


def _kwargs(name, geometry):
    """build_plane_operator arguments of ``name`` from ``geometry``'s module
    (the chroma case takes its crop from ``chroma_crop``)."""
    sw, sh, dw, dh, tap, kw = GEOMS[name]
    kw = dict(kw)
    cplace = kw.pop("cplace", None)
    if cplace is None:
        return dict(src_width=sw, src_height=sh, dst_width=dw, dst_height=dh, **kw), tap
    cl, ct, cw, ch = geometry.chroma_crop(cplace, sw, sh, dw, dh, 0.0, 0.0, float(sw), float(sh), 1, 1)
    return dict(
        src_width=sw >> 1, src_height=sh >> 1, dst_width=dw >> 1, dst_height=dh >> 1,
        crop_left=cl, crop_top=ct, crop_width=cw, crop_height=ch,
    ), tap  # fmt: skip


def _build(operator, geometry, name):
    kw, tap = _kwargs(name, geometry)
    return operator.build_plane_operator(radius=operator.radius_for_tap(tap), **kw)


def _code_lines(path):
    return [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("//")]


def test_native_builders_are_separate_and_present():
    """Both native libraries build, from the same code (comments aside),
    to different files."""
    assert _code_lines(tnative._source_path()) == _code_lines(jnative._source_path())
    assert tnative._cache_path() != jnative._cache_path()
    assert tnative._cache_path().parent.parent == tnative.BUILD_ROOT
    if jnative.get_library() is not None:
        assert tnative.get_library() is not None


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("name", list(GEOMS))
def test_operator_bit_identical(name, builder):
    if builder == "numpy":
        with numpy_builder(jnative), numpy_builder(tnative):
            want = _build(joperator, jgeometry, name)
            got = _build(toperator, tgeometry, name)
    else:
        want = _build(joperator, jgeometry, name)
        got = _build(toperator, tgeometry, name)
    assert_same(got, want)
    assert got.stats() == want.stats()


@pytest.mark.parametrize("name", list(GEOMS))
def test_plans_kernels_and_golden_bit_identical(name):
    """plan_phases, plan_phases_seg, build_conv_kernels and the golden apply."""
    jop = _build(joperator, jgeometry, name)
    top = _build(toperator, tgeometry, name)
    jplan, tplan = jphase.plan_phases(jop), tphase.plan_phases(top)
    assert_same(tplan, jplan)
    assert_same(tphase.plan_phases_seg(top), jphase.plan_phases_seg(jop))
    if jplan is not None:
        assert_same(tphase.build_conv_kernels(top, tplan), jphase.build_conv_kernels(jop, jplan))
    src = np.random.default_rng(3).random((top.src_height, top.src_width), dtype=np.float32)
    assert_same(tgolden.apply_plane_numpy(top, src), jgolden.apply_plane_numpy(jop, src))
    src8 = (src * 255).astype(np.uint8)
    assert_same(
        tgolden.apply_plane_numpy(top, src8, out_dtype=np.uint8, peak=255.0),
        jgolden.apply_plane_numpy(jop, src8, out_dtype=np.uint8, peak=255.0),
    )


@pytest.mark.parametrize("name", list(GEOMS))
def test_geometry_and_lut_bit_identical(name):
    jkw, tap = _kwargs(name, jgeometry)
    tkw, _ = _kwargs(name, tgeometry)
    assert tkw == jkw
    radius = joperator.radius_for_tap(tap)
    assert toperator.radius_for_tap(tap) == radius
    blur = jkw.get("blur", 1.0)
    assert_same(tfilters.build_lut(radius, blur), jfilters.build_lut(radius, blur))
    args = dict(
        src_width=jkw["src_width"], src_height=jkw["src_height"],
        dst_width=jkw["dst_width"], dst_height=jkw["dst_height"], radius=radius,
        crop_left=jkw.get("crop_left", 0.0), crop_top=jkw.get("crop_top", 0.0),
        crop_width=float(jkw.get("crop_width", jkw["src_width"])),
        crop_height=float(jkw.get("crop_height", jkw["src_height"])),
        quantize_x=jkw.get("quantize_x", 256), quantize_y=jkw.get("quantize_y", 256),
        pos_dtype=jkw.get("pos_precision") or "f32",
    )  # fmt: skip
    assert_same(tgeometry.build_plane_geometry(**args), jgeometry.build_plane_geometry(**args))


def test_filters_constants_identical():
    assert_same(np.asarray(tfilters.JINC_ZEROS), np.asarray(jfilters.JINC_ZEROS))
    assert tfilters.LUT_SIZE == jfilters.LUT_SIZE


@pytest.mark.parametrize("cplace", ["mpeg2", "mpeg1", "topleft"])
def test_chroma_crop_identical(cplace):
    for sub in ((1, 1), (1, 0), (2, 0)):
        args = (cplace, 1920, 1080, 1280, 720, 0.5, 0.25, 1919.0, 1079.5, *sub)
        assert tgeometry.chroma_crop(*args) == jgeometry.chroma_crop(*args)


FORMATS = ["yuv420p", "yuv422p", "yuv444p", "yuv411p", "rgbp", "gray"]


@pytest.mark.parametrize("bits", [8, 10, 16, 32])
@pytest.mark.parametrize("fmt", FORMATS)
def test_clip_formats_and_frames_identical(fmt, bits):
    tf, jf = getattr(tclip, fmt)(bits), getattr(jclip, fmt)(bits)
    assert_same(tf, jf)
    for prop in ("dtype", "peak", "plane_names", "is_420", "is_422", "is_411", "is_444"):
        assert getattr(tf, prop) == getattr(jf, prop), prop
    tfr = tclip.random_frame(tf, 36, 24, seed=5, props={"_ChromaLocation": 1})
    jfr = jclip.random_frame(jf, 36, 24, seed=5, props={"_ChromaLocation": 1})
    assert_same(tfr, jfr)
    tfr.validate()
    c = tclip.Clip.from_frames([tfr, tfr.with_props(x=1)])
    assert (c.width, c.height, len(c)) == (36, 24, 2)


def test_reference_sample_pixels_identical():
    src = np.random.default_rng(4).integers(0, 256, (48, 64)).astype(np.uint8)
    ys, xs = np.array([0, 5, 47, 95, 30]), np.array([0, 127, 60, 3, 64])
    radius = joperator.radius_for_tap(4)
    want = jgolden.reference_sample_pixels(src, ys, xs, 128, 96, radius, crop_left=0.25)
    got = tgolden.reference_sample_pixels(src, ys, xs, 128, 96, radius, crop_left=0.25)
    assert_same(got, want)


def test_operator_cache_round_trip_in_its_own_directory(tmp_path, monkeypatch):
    """The port's cache writes what the JAX cache writes, under the same key,
    but in its own default directory."""
    monkeypatch.delenv("JINCRESIZE_CACHE_DIR", raising=False)
    monkeypatch.delenv("JINCRESIZE_TORCH_CACHE_DIR", raising=False)
    assert tcache.default_cache_dir() != jcache.default_cache_dir()
    monkeypatch.setenv("JINCRESIZE_TORCH_CACHE_DIR", str(tmp_path / "t"))
    assert tcache.default_cache_dir() == tmp_path / "t"
    geo = dict(src_width=48, src_height=32, dst_width=72, dst_height=50, radius=joperator.radius_for_tap(3))
    assert tcache.geometry_key(**geo) == jcache.geometry_key(**geo)
    built = tcache.cached_build(toperator.build_plane_operator, **geo)
    (path,) = (tmp_path / "t").glob("op_*.npz")
    loaded = tcache.cached_build(lambda **g: pytest.fail("cache miss"), **geo)
    assert_same(loaded, built)
    jcache.save_operator(joperator.build_plane_operator(**geo), tmp_path / "j.npz")
    assert_same(tcache.load_operator(tmp_path / "j.npz"), built)
    assert path.name == f"op_{jcache.geometry_key(**geo)}.npz"
