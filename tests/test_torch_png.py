"""The port's PNG codec (ssl_tpu_torch/utils/png.py) against cv2: files that
cv2 writes and files of every filter type decode bit for bit as
``cv2.imdecode`` decodes them, for each imread flag; and ``imfrombytes`` /
``imwrite`` with cv2 hidden give what they give with cv2."""

import os
import sys

import cv2
import numpy as np
import pytest

from ssl_tpu_torch.utils import img_util, png

FLAGS = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}


def _image(channels, h=37, w=53, seed=0):
    """A smooth field with noise, a flat block and sharp edges, uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(yy / 5.0)[..., None] * 60 + xx[..., None] * 2 + 100 + \
        rng.randint(0, 30, (h, w, channels))
    base[10:20, 5:30] = 250
    base[25:, 40:] = 3
    img = np.clip(base, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _row_filters(data: bytes) -> set:
    return set(png.row_filters(data).tolist())


def _assert_decodes_as_cv2(data: bytes):
    for flag, code in FLAGS.items():
        want = cv2.imdecode(np.frombuffer(data, np.uint8), code)
        got = png.decode_png(data, flag)
        assert got.dtype == np.uint8 and got.shape == want.shape, (flag, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=flag)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "bgr", "bgra"])
def test_decodes_cv2_written_pngs_bit_for_bit(channels):
    """PNG compression 0-9: libpng picks among the filters per row."""
    img = _image(channels)
    used = set()
    for level in range(10):
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok
        data = buf.tobytes()
        used |= _row_filters(data)
        _assert_decodes_as_cv2(data)
    assert len(used) >= 3, used                      # several filter types were exercised


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "bgr", "bgra"])
def test_own_pngs_of_every_filter_decode_as_cv2(channels, filter_type):
    img = _image(channels, seed=channels)
    data = png.encode_png(img, filter_type)
    if filter_type is not None:
        assert _row_filters(data) == {filter_type}
    _assert_decodes_as_cv2(data)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8),
                                               cv2.IMREAD_UNCHANGED), img)


def test_colour_to_grey_matches_cv2_on_random_triples():
    """The grayscale flag on colour PNGs over 2^16 random RGB triples (the
    integer weights were checked on all 2^24 once; this keeps it pinned)."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img)
    np.testing.assert_array_equal(png.decode_png(buf.tobytes(), "grayscale"),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def test_unsupported_pngs_raise():
    ok, buf16 = cv2.imencode(".png", np.full((4, 4), 1000, np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode_png(buf16.tobytes())
    data = bytearray(png.encode_png(_image(3)))
    data[45] ^= 0xFF                                     # inside the IDAT data
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))


def test_imfrombytes_and_imwrite_without_cv2(tmp_path, monkeypatch):
    """With cv2 hidden the PNG path gives cv2's arrays; other formats raise."""
    data = {c: cv2.imencode(".png", _image(c, seed=7))[1].tobytes() for c in (1, 3, 4)}
    want = {(c, f, fl): img_util.imfrombytes(data[c], flag=f, float32=fl)
            for c in data for f in FLAGS for fl in (False, True)}
    ok, jpg = cv2.imencode(".jpg", _image(3))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for (c, f, fl), w in want.items():
        got = img_util.imfrombytes(data[c], flag=f, float32=fl)
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w, err_msg=f"{c} {f} {fl}")
    with pytest.raises(ImportError, match="cv2"):
        img_util.imfrombytes(jpg.tobytes())
    img = _image(3, seed=9)
    path = os.path.join(tmp_path, "sub", "x.png")
    assert img_util.imwrite(img, path)
    with pytest.raises(ImportError, match="cv2"):
        img_util.imwrite(img, os.path.join(tmp_path, "x.jpg"))
    monkeypatch.undo()
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
