"""PNG decoder and encoder on ``zlib`` and numpy.

The port decodes its training and validation images with ``cv2`` where it
imports (``utils/img_util.py``), as the JAX package does.  A machine without
``cv2`` decodes PNG through this module instead, which gives ``cv2``'s
result bit for bit (``tests/test_torch_png.py`` holds it against
``cv2.imdecode``):

* 8-bit, non-interlaced PNGs of colour types 0 (grey), 2 (RGB) and 6 (RGBA),
  with all five row filters.  None, Sub and Up rows are reconstructed with
  whole-row numpy operations; Average and Paeth depend on the reconstructed
  pixel to their left and go pixel by pixel over the row's bytes.
* ``cv2``'s layout for each ``imread`` flag: BGR(A) channel order; under
  ``color`` a grey image is replicated to 3 channels and alpha is dropped;
  under ``grayscale`` a colour image is reduced to grey as ``cv2`` 5's PNG
  decoder does (15-bit weights, truncated; equal to ``cv2`` on every one of
  the 2^24 RGB triples); ``unchanged`` keeps the file's channels.

Palette, 16-bit, sub-byte and interlaced images raise ``ValueError``.

``encode_png`` writes 8-bit PNGs (colour type from the channel count, BGR(A)
input as ``cv2.imwrite`` takes it) with one filter type for every row, or,
by default, the filter libpng's heuristic picks per row (the least sum of
absolute filtered bytes, read as signed)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}
# cv2's colour-to-grey conversion in its PNG decoder: grey = (r R + g G + b B)
# >> 15, truncated, with weights that sum to 2^15.
_GREY_R, _GREY_G, _GREY_B = 9797, 19234, 3737


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    filters, data = rows[:, 0], rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, row = int(filters[y]), data[y]
        if f == 0:
            out[y] = row
        elif f == 1:
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            out[y] = row + prev
        elif f in (3, 4):
            cur = bytearray(row.tobytes())
            (_average_row if f == 3 else _paeth_row)(cur, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {f}")
        prev = out[y]
    return out


def _parse(data: bytes):
    """(IHDR fields, the inflated image data) of an 8-bit non-interlaced
    grey, RGB or RGBA PNG."""
    if not is_png(data):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"PLTE", b"tRNS"):
            raise ValueError(f"PNG: {kind.decode()} chunks are not supported")
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}: "
                         "only 8-bit non-interlaced grey, RGB and RGBA are supported")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * _CHANNELS[ctype] + 1):
        raise ValueError("PNG: image data has the wrong size")
    return header, raw


def row_filters(data: bytes) -> np.ndarray:
    """The filter type of each row of a PNG (its decode cost: types 3 and 4
    go pixel by pixel)."""
    (width, height, _, ctype, _, _, _), raw = _parse(data)
    return raw.reshape(height, width * _CHANNELS[ctype] + 1)[:, 0].copy()


def decode_png(data: bytes, flag: str = "color") -> np.ndarray:
    """PNG bytes -> uint8 array as ``cv2.imdecode`` gives it for ``flag``
    (``color``: (h, w, 3) BGR; ``grayscale``: (h, w); ``unchanged``: (h, w)
    grey, (h, w, 3) BGR or (h, w, 4) BGRA)."""
    if flag not in ("color", "grayscale", "unchanged"):
        raise ValueError(f"unknown imread flag {flag!r}")
    (width, height, _, ctype, _, _, _), raw = _parse(data)
    ch = _CHANNELS[ctype]
    img = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)

    if flag == "grayscale":
        if ch == 1:
            return img[..., 0].copy()
        rgb = img[..., :3].astype(np.uint32)
        grey = (_GREY_R * rgb[..., 0] + _GREY_G * rgb[..., 1] + _GREY_B * rgb[..., 2]) >> 15
        return grey.astype(np.uint8)
    if ch == 1:
        return (np.repeat(img, 3, axis=2) if flag == "color" else img[..., 0].copy())
    bgr = img[..., [2, 1, 0]]
    if ch == 4 and flag == "unchanged":
        return np.concatenate([bgr, img[..., 3:]], axis=2)
    return np.ascontiguousarray(bgr)


def _filtered(img: np.ndarray, bpp: int) -> np.ndarray:
    """(5, h, stride) uint8: every row under each of the filter types 0-4,
    from the raw bytes (encoding needs no sequential pass)."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    return np.stack([(x - pr).astype(np.uint8) for pr in preds])


def encode_png(img: np.ndarray, filter_type: int | None = None, level: int = 6) -> bytes:
    """uint8 (h, w), (h, w, 1), (h, w, 3) BGR or (h, w, 4) BGRA -> PNG bytes.
    ``filter_type`` 0-4 filters every row alike; None picks per row as
    libpng's heuristic does."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch == 3:
        img = img[..., [2, 1, 0]]
    elif ch == 4:
        img = img[..., [2, 1, 0, 3]]
    elif ch != 1:
        raise ValueError(f"encode_png: {ch} channels")
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    cand = _filtered(rows, ch)
    if filter_type is None:
        cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)   # (5, h)
        choice = cost.argmin(axis=0)
    elif filter_type in range(5):
        choice = np.full(h, filter_type)
    else:
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    body = np.concatenate([choice.astype(np.uint8)[:, None],
                           cand[choice, np.arange(h)]], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level)) + chunk(b"IEND", b""))
