"""The port's native zstd codec and JPEG decoder against the JAX package's.

Both packages build the same C++ (``tpuframe_torch/csrc/{codec,jpegdec}.cpp``
is the port's own copy) with ``g++`` against the same libzstd and libjpeg,
so equal inputs must give equal bytes.  The CPU test machines have
``zstd.h`` and ``jpeglib.h``, so the native builds are asserted, never
skipped.

- The port builds both libraries from its own sources into
  ``build/tpuframe_torch/``, and never loads ``tpuframe/_native/build``.
- ``ZstdCodec``: compressed frames bit-equal to JAX's at levels 1, 3 and
  19; ``decompress`` and ``decompress_batch`` invert either side's frames;
  the same from the header-less build against libzstd's runtime soname
  (the card machine has no ``zstd.h``).
- ``JpegDecoder``: the pixels of the committed fixture JPEGs and of a
  seeded grayscale one, bit-equal to JAX's at full size and at every
  ``min_hw`` that picks another DCT scale (the M/8 rule), and the same
  refusals: the decompression-bomb guard (by the header's declared size,
  also under ``min_hw``), a truncated file and a header that is no JPEG.
- The streaming decode path (``streaming._dec_image``): native, and with
  the native decoder off (PIL's draft), bit-equal to JAX's; the
  ``TPUFRAME_JPEG_THREADS`` knob read as JAX reads it.

Tolerance: exact (``bytes`` equal, ``np.array_equal``) throughout.
"""

import io
from pathlib import Path

import numpy as np
import pytest

from tpuframe.core import native as jax_native
from tpuframe.data import streaming as jax_streaming
from tpuframe_torch.core import native
from tpuframe_torch.data import streaming

REPO = Path(__file__).resolve().parents[1]
FIXTURES = sorted((REPO / "tests" / "fixtures" / "images").rglob("*.jpg"))


def test_the_native_libraries_build_from_the_ports_sources():
    assert native.native_available(), native.build_errors
    assert native.jpeg_native_available(), native.build_errors
    assert native.build_errors["tfscodec"] is None and native.build_errors["tfjpeg"] is None
    for name, source in (("tfscodec", "codec.cpp"), ("tfjpeg", "jpegdec.cpp")):
        lib = Path(native._LIBS[name]._name)
        assert lib.parent == REPO / "build" / "tpuframe_torch", lib
        assert lib.name.startswith(f"lib{name}-") and (REPO / "tpuframe_torch" / "csrc" /
                                                      source).is_file()
        assert "_native" not in str(lib)
    assert streaming._codec_name() == "native"
    assert streaming._decoder_name() == "native"


def _payloads():
    rng = np.random.default_rng(7)
    return [
        b"",
        b"abc" * 1000,
        rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),  # incompressible
        np.repeat(rng.integers(0, 8, 4096, dtype=np.uint8), 37).tobytes(),
    ]


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_frames_are_the_jax_codecs_bit_for_bit(level):
    mine, theirs = native.ZstdCodec(), jax_native.ZstdCodec()
    for raw in _payloads():
        frame = mine.compress(raw, level)
        assert frame == theirs.compress(raw, level)
        assert mine.decompress(frame, max_output_size=len(raw)) == raw
        assert theirs.decompress(frame, max_output_size=len(raw)) == raw


def test_zstd_batch_decompress_inverts_either_side():
    mine, theirs = native.ZstdCodec(n_threads=3), jax_native.ZstdCodec(n_threads=3)
    raws = _payloads()[1:]
    frames = [theirs.compress(r, 3) for r in raws]
    assert mine.decompress_batch(frames) == raws  # sizes from the frame headers
    assert mine.decompress_batch(frames, [len(r) for r in raws]) == raws
    with pytest.raises(RuntimeError, match="decompress failed on frame 1"):
        mine.decompress_batch([frames[0], frames[1][:-7]], [len(raws[0]), len(raws[1])])


def test_the_codec_builds_without_zstd_h_against_libzstds_runtime_library(tmp_path):
    """Where only libzstd's runtime library is installed (no ``zstd.h``, no
    ``libzstd.so``), ``codec.cpp`` declares the entry points it uses and
    links the soname: built so here (the header hidden), its frames are
    JAX's codec's, bit for bit."""
    import ctypes
    import subprocess

    source = (REPO / "tpuframe_torch" / "csrc" / "codec.cpp").read_text()
    assert source.count("#if __has_include(<zstd.h>)") == 1
    src = tmp_path / "codec_no_header.cpp"
    src.write_text(source.replace("#if __has_include(<zstd.h>)", "#if 0"))
    so = tmp_path / "libcodec_no_header.so"
    subprocess.run(["g++", *native._FLAGS, str(src), "-o", str(so), "-lpthread",
                    "-l:libzstd.so.1"], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    native._declare_codec(lib)
    mine = native.ZstdCodec()
    mine._lib = lib
    theirs = jax_native.ZstdCodec()
    for raw in _payloads():
        frame = mine.compress(raw, 3)
        assert frame == theirs.compress(raw, 3)
        assert mine.decompress(frame, max_output_size=len(raw)) == raw


def _gray_jpeg() -> bytes:
    from PIL import Image

    rng = np.random.default_rng(11)
    img = np.kron(rng.integers(0, 256, (6, 5), dtype=np.uint8), np.ones((9, 13), np.uint8))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _blobs() -> list[bytes]:
    return [p.read_bytes() for p in FIXTURES[:6]] + [_gray_jpeg()]


@pytest.mark.parametrize("min_hw", [None, (1, 1), (8, 8), (16, 24), (33, 20), (10_000, 10_000)],
                         ids=["full", "1x1", "8x8", "16x24", "33x20", "beyond"])
def test_jpeg_decode_is_the_jax_decoders_bit_for_bit(min_hw):
    assert len(FIXTURES) >= 6
    blobs = _blobs()
    got = native.JpegDecoder(n_threads=2).decode_batch(blobs, min_hw=min_hw)
    want = jax_native.JpegDecoder(n_threads=2).decode_batch(blobs, min_hw=min_hw)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert got[-1].ndim == 2  # grayscale stays one channel
    full = native.JpegDecoder().decode_batch(blobs)
    for g, f in zip(got, full):  # decode at scale never undershoots, never upscales
        h, w = min_hw or (0, 0)
        assert g.shape[0] <= f.shape[0] and g.shape[1] <= f.shape[1]
        assert g.shape[0] >= min(h, f.shape[0]) and g.shape[1] >= min(w, f.shape[1])


@pytest.mark.parametrize("min_hw", [None, (4, 4)], ids=["full", "at_scale"])
def test_the_bomb_guard_refuses_as_jax_does(min_hw):
    blob = FIXTURES[0].read_bytes()
    h, w = native.JpegDecoder().decode(blob).shape[:2]
    errors = []
    for pkg in (native, jax_native):
        with pytest.raises(ValueError, match="decompression-bomb guard") as info:
            pkg.JpegDecoder(max_pixels=h * w - 1).decode(blob, min_hw=min_hw)
        errors.append(str(info.value))
        assert pkg.JpegDecoder(max_pixels=h * w).decode(blob).shape[:2] == (h, w)
    assert errors[0] == errors[1]
    assert native._pil_max_pixels() == jax_native._pil_max_pixels()


def test_corrupt_jpegs_are_refused_as_jax_refuses_them():
    blob = FIXTURES[1].read_bytes()
    for bad in (blob[: len(blob) // 2], b"\xff\xd8not a jpeg at all"):
        errors = []
        for pkg in (native, jax_native):
            with pytest.raises(ValueError) as info:
                pkg.JpegDecoder().decode(bad)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


@pytest.fixture
def fresh_decoders(monkeypatch):
    """Both packages' lazy decoder singletons unset (restored after)."""
    monkeypatch.setattr(streaming, "_JPEG_DECODER", "unset")
    monkeypatch.setattr(jax_streaming, "_JPEG_DECODER", "unset")


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "pil"])
@pytest.mark.parametrize("min_hw", [None, (8, 8), (20, 20)], ids=["full", "8x8", "20x20"])
def test_the_streaming_decode_path_is_jaxs(native_on, min_hw, fresh_decoders, monkeypatch):
    if not native_on:
        monkeypatch.setenv("TPUFRAME_NATIVE_JPEG", "0")
    assert (streaming._native_jpeg() is not None) is native_on
    assert streaming._decoder_name() == ("native" if native_on else "pil")
    for blob in _blobs():
        got = streaming._dec_image(blob, min_hw=min_hw)
        want = jax_streaming._dec_image(blob, min_hw=min_hw)
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("raw,threads", [("3", 3), ("abc", 1), ("0", 1)])
def test_jpeg_threads_knob_reads_as_jax(raw, threads, fresh_decoders, monkeypatch):
    monkeypatch.setenv("TPUFRAME_JPEG_THREADS", raw)
    monkeypatch.delenv("TPUFRAME_NATIVE_JPEG", raising=False)
    if raw == "abc":
        with pytest.warns(UserWarning, match="not an integer"):
            mine = streaming._native_jpeg()
        with pytest.warns(UserWarning, match="not an integer"):
            theirs = jax_streaming._native_jpeg()
    else:
        mine, theirs = streaming._native_jpeg(), jax_streaming._native_jpeg()
    assert mine.n_threads == theirs.n_threads == threads
