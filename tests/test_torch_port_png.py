"""The port's PNG decoder (utils/png.py) on every kind of PNG that libpng
reads, against cv2 5.0: grey at bit depth 1, 2, 4, 8 and 16, grey + alpha,
RGB and RGBA at 8 and 16, palette images at 1, 2, 4 and 8 with and without
tRNS, each plain and Adam7-interlaced, every row under a random filter, at
odd sizes (1-pixel-wide and 1-pixel-high images leave Adam7 passes empty).
`decode(buf, color=True)` equals cv2.imdecode(IMREAD_COLOR) and `decode(buf)`
equals cv2.imdecode(IMREAD_UNCHANGED), exactly (grey + alpha, which decode
keeps as 2 channels, spread to cv2's BGRA). cv2 writes none of these
kinds but 16-bit ones, so the test writes the files itself (`write_png`).
"""

import struct
import zlib

import numpy as np
import pytest

from yolo_dual_tpu_torch.utils import png

cv2 = pytest.importorskip("cv2")

# colour type -> channels
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (4, 8), (4, 16), (2, 8), (2, 16), (6, 8),
         (6, 16), (3, 1), (3, 2), (3, 4), (3, 8)]
SIZES = [(13, 11), (1, 7), (9, 1), (37, 29)]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _pack(img: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> the PNG's row bytes (h, row bytes)."""
    h = img.shape[0]
    if depth == 16:
        return img.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return img.astype(np.uint8).reshape(h, -1)
    flat = img.reshape(h, -1).astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row under a random one of the five filters, with its type byte."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r in rows.astype(np.int32):
        k = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pa, pb, pc = np.abs(prev - ul), np.abs(left - ul), np.abs(left + prev - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        pred = (0, left, prev, (left + prev) >> 1, paeth)[k]
        out.append(bytes([k]) + ((r - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def write_png(samples, ctype, depth, interlace, rng, plte=None, trns=None) -> bytes:
    """PNG bytes of (h, w, ch) samples (RGB order) of colour type `ctype` at
    `depth`, Adam7-interlaced or not, rows under random filters."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = png.ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b"".join(_filter(_pack(samples[y0::dy, x0::dx], depth), bpp, rng)
                    for x0, y0, dx, dy in passes if x0 < w and y0 < h)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    out = png.SIGNATURE + _chunk(b"IHDR", ihdr)
    if plte is not None:
        out += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data, 6)) + _chunk(b"IEND", b"")


def case(ctype, depth, size, interlace, trns, seed):
    rng = np.random.default_rng(seed)
    h, w = size
    top = 2 ** depth
    if ctype == 3:
        n = int(rng.integers(max(1, top // 2), top + 1))  # a palette shorter than the depth allows
        samples = rng.integers(0, n, (h, w, 1))
        plte = rng.integers(0, 256, (n, 3))
        t = rng.integers(0, 256, max(1, n - 1), dtype=np.uint8).tobytes() if trns else None
        return write_png(samples, 3, depth, interlace, rng, plte, t)
    samples = rng.integers(0, top, (h, w, CHANNELS[ctype]))
    t = None
    if trns and ctype in (0, 2):  # a single transparent colour
        t = struct.pack(">" + "H" * CHANNELS[ctype], *samples[0, 0].tolist())
    return write_png(samples, ctype, depth, interlace, rng, trns=t)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", KINDS, ids=[f"type{c}_depth{d}" for c, d in KINDS])
def test_decode_equals_cv2(ctype, depth, interlace):
    for i, size in enumerate(SIZES):
        for trns in ((False, True) if ctype in (0, 2, 3) else (False,)):
            buf = case(ctype, depth, size, interlace, trns, seed=100 * ctype + 10 * depth + i)
            arr = np.frombuffer(buf, np.uint8)
            want = cv2.imdecode(arr, cv2.IMREAD_COLOR)
            assert want is not None and want.shape == (*size, 3)
            np.testing.assert_array_equal(png.decode(buf, color=True), want)
            np.testing.assert_array_equal(png.imdecode_color(buf), want)
            want = cv2.imdecode(arr, cv2.IMREAD_UNCHANGED)
            got = png.decode(buf)
            if ctype == 4:  # decode keeps grey + alpha as 2 channels; cv2 spreads them to BGRA
                got = got[..., [0, 0, 0, 1]]
            assert got.dtype == want.dtype, (got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want)


def test_invalid_headers_and_palettes_are_refused():
    rng = np.random.default_rng(0)
    samples = rng.integers(0, 4, (5, 6, 1))
    for ctype, depth in ((2, 4), (3, 16), (4, 2), (6, 1), (7, 8)):
        buf = write_png(np.zeros((2, 2, CHANNELS.get(ctype, 1)), int), ctype, depth, False, rng)
        with pytest.raises(ValueError, match="not a valid PNG"):
            png.decode(buf)
    with pytest.raises(ValueError, match="without a PLTE"):
        png.decode(write_png(samples, 3, 2, False, rng))
    with pytest.raises(ValueError, match="palette index"):
        png.decode(write_png(samples, 3, 2, False, rng, plte=np.zeros((2, 3), int)))
