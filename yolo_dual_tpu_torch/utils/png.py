"""PNG codec in numpy and zlib: the port's stand-in for
`cv2.imencode(".png")` and `cv2.imdecode`, which the JAX package's serve.py
and io/remote.py call, so the server and its client run without cv2.

It keeps cv2's channel order: `encode` reads a 3- or 4-channel array as BGR
or BGRA, and `decode` returns BGR or BGRA, so a round trip through this codec
equals one through cv2's. `encode` writes 8-bit images. `decode` reads every
PNG that libpng (cv2) reads: grey at bit depth 1, 2, 4, 8 or 16, grey + alpha,
RGB and RGBA at 8 or 16, palette images (PLTE, tRNS) at 1, 2, 4 or 8, plain
or Adam7-interlaced, with all five row filters; it gives what
cv2.imdecode(IMREAD_UNCHANGED) gives, or with `color` what IMREAD_COLOR
gives (8-bit BGR: 16-bit samples keep their high byte, grey below 8 bits is
scaled to 0-255, a palette is looked up, grey is spread to three channels and
alpha dropped).

Rows filtered with None, Sub or Up decode a row at a time (Sub is a wrapping
cumsum). Average and Paeth rows depend on the pixel to their left, so an image
with any of them decodes along anti-diagonals, a step for each of h + w - 1
diagonals, each vectorised over the rows it crosses; libpng (cv2) picks filters
row by row and writes such rows. The filters act on bytes: a pixel's left
neighbour is the byte one pixel back (one byte below 8 bits a pixel). An
interlaced image is seven such images (the Adam7 passes), each filtered on
its own.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}    # channels -> PNG colour type


def is_png(buf) -> bool:
    return bytes(buf[:8]) == SIGNATURE


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _to_rgb_order(a: np.ndarray) -> np.ndarray:
    if a.shape[2] == 3:
        return a[..., ::-1]
    if a.shape[2] == 4:
        return a[..., [2, 1, 0, 3]]
    return a


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode(img: np.ndarray, filter_type: str = "sub") -> bytes:
    """PNG bytes of a uint8 image: (h, w) or (h, w, 1) grey, (h, w, 2) grey +
    alpha, (h, w, 3) BGR or (h, w, 4) BGRA, as cv2.imencode(".png") reads it.
    Every row takes `filter_type` (none, sub, up, average or paeth); zlib at
    level 1, cv2's default."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode: 8-bit images only, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPES or 0 in a.shape[:2]:
        raise ValueError(f"encode: expected (h, w[, 1|2|3|4]) with h, w > 0, got {a.shape}")
    h, w, ch = a.shape
    raw = np.ascontiguousarray(_to_rgb_order(a)).reshape(h, w * ch)
    rows = np.empty((h, w * ch + 1), np.uint8)
    rows[:, 0] = FILTERS[filter_type]
    if filter_type == "none":
        rows[:, 1:] = raw
    elif filter_type == "sub":                    # uint8 arithmetic wraps mod 256
        rows[:, 1:ch + 1] = raw[:, :ch]
        np.subtract(raw[:, ch:], raw[:, :-ch], out=rows[:, ch + 1:])
    else:
        r16 = raw.astype(np.int16)
        left, up, upleft = (np.zeros_like(r16) for _ in range(3))
        left[:, ch:] = r16[:, :-ch]
        up[1:] = r16[:-1]
        upleft[1:, ch:] = r16[:-1, :-ch]
        pred = {"up": up, "average": (left + up) >> 1,
                "paeth": _paeth(left, up, upleft)}[filter_type]
        rows[:, 1:] = (r16 - pred) & 0xFF
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def _unfilter_rows(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of None, Sub and Up filters, a row at a time."""
    h, n = rows.shape
    if (kinds <= 1).all():                        # no row reads the one above: all at once
        sub = np.cumsum(rows.reshape(h, -1, bpp), 1, dtype=np.uint8).reshape(h, n)
        return np.where(kinds[:, None] == 1, sub, rows)
    out = np.empty((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for y in range(h):
        f = rows[y]
        if kinds[y] == 0:
            out[y] = f
        elif kinds[y] == 1:
            out[y] = np.cumsum(f.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = f + prev
        prev = out[y]
    return out


def _unfilter_diagonals(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters. Pixel (y, x) needs (y, x-1), (y-1, x) and
    (y-1, x-1), all on the two diagonals before its own, so the image is
    skewed (row y shifted right by y) and decoded a column of the skew at a
    time."""
    h, n = rows.shape
    w = n // bpp
    filt = rows.reshape(h, w, bpp).astype(np.int16)
    skew = np.zeros((h + 1, w + h + 1, bpp), np.int16)  # row 0 and column 0: the zero frame
    ys = np.arange(h)
    kind = kinds.astype(np.int16)[:, None]
    for d in range(w + h - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d)
        y = ys[y0:y1 + 1]
        col = d + 1                     # skew column of diagonal d (column 0 is the frame)
        a = skew[y + 1, col - 1]        # (y, x-1)
        b = skew[y, col - 1]            # (y-1, x)
        c = skew[y, col - 2] if col >= 2 else np.zeros_like(a)  # (y-1, x-1)
        k = kind[y0:y1 + 1]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        skew[y + 1, col] = (filt[y, d - y] + pred) & 0xFF
    # the frame: a pixel of row y at x = 0 reads column 0 of its skewed row,
    # (y, -1) -> skew[y+1, y] which stays 0 since diagonals start at column y+1
    out = skew[ys[:, None] + 1, ys[:, None] + 1 + np.arange(w)[None]]
    return out.astype(np.uint8).reshape(h, n)


# colour type -> (channels, allowed bit depths)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
          6: (4, (8, 16))}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunks(b: bytes) -> dict:
    """IHDR's fields, PLTE, tRNS and the joined IDAT data of PNG bytes `b`."""
    if not is_png(b):
        raise ValueError("not a PNG")
    pos, out, idat = 8, {}, []
    while pos + 8 <= len(b):
        n, kind = struct.unpack(">I4s", b[pos:pos + 8])
        data = b[pos + 8:pos + 8 + n]
        if len(data) != n or pos + 12 + n > len(b):
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", b[pos + 8 + n:pos + 12 + n])[0]
        if crc != zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            out["IHDR"] = struct.unpack(">IIBBBBB", data)
        elif kind in (b"PLTE", b"tRNS"):
            out[kind.decode()] = data
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if "IHDR" not in out or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    out["IDAT"] = b"".join(idat)
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """The (h, w, ch) samples of unfiltered rows: uint16 at depth 16 (big
    endian), else uint8, sub-byte samples unpacked from the high bit down."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :w * ch * 2].copy().view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(2, dtype=np.uint8)
    return vals[:, :w * ch].reshape(h, w, ch)


def decode(buf, color: bool = False) -> np.ndarray:
    """The image of PNG bytes `buf` as cv2.imdecode(IMREAD_UNCHANGED) gives it:
    (h, w) grey, (h, w, 2) grey + alpha (cv2 gives BGRA, the grey spread),
    (h, w, 3) BGR or (h, w, 4) BGRA, uint16
    at bit depth 16, uint8 else (grey below 8 bits scaled to 0-255); a palette
    image as BGR, and it or an RGB image as BGRA where it has a tRNS chunk. With `color`, (h, w, 3)
    uint8 BGR as IMREAD_COLOR gives it (module docstring). Raises ValueError
    on anything else."""
    c = _chunks(bytes(buf))
    w, h, depth, ctype, _, _, interlace = c["IHDR"]
    if ctype not in _TYPES or depth not in _TYPES[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth}: not a valid PNG")
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace}")
    if ctype == 3 and "PLTE" not in c:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _TYPES[ctype][0]
    bits = ch * depth
    bpp = max(1, bits // 8)  # the filters' byte distance to the left neighbour
    try:
        raw = zlib.decompress(c["IDAT"])
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8 + 1
        if len(raw) < pos + ph * stride:
            raise ValueError("PNG image data too short")
        rows = np.frombuffer(raw, np.uint8, ph * stride, pos).reshape(ph, stride)
        pos += ph * stride
        kinds = rows[:, 0]
        if (kinds > 4).any():
            raise ValueError(f"PNG filter type {int(kinds.max())}")
        unfilter = _unfilter_diagonals if (kinds >= 3).any() else _unfilter_rows
        img[y0::dy, x0::dx] = _samples(unfilter(np.ascontiguousarray(rows[:, 1:]), kinds, bpp),
                                       pw, ch, depth)
    if ctype == 3:
        plte = np.frombuffer(c["PLTE"], np.uint8)
        lut = plte[:len(plte) // 3 * 3].reshape(-1, 3)[:, ::-1]  # BGR
        if int(img.max()) >= len(lut):
            raise ValueError(f"PNG palette index {int(img.max())} past the palette's {len(lut)}")
        if not color and "tRNS" in c:
            alpha = np.full(len(lut), 255, np.uint8)
            t = np.frombuffer(c["tRNS"], np.uint8)[:len(lut)]
            alpha[:len(t)] = t
            lut = np.concatenate([lut, alpha[:, None]], 1)
        return np.ascontiguousarray(lut[img[..., 0]])
    if depth < 8:  # libpng's expansion of low-depth grey
        img = img * np.uint8(255 // (2 ** depth - 1))
    if color:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, 2) if ch <= 2
                                    else img[..., 2::-1])
    if ch == 1:
        return img[..., 0]
    if ctype == 2 and "tRNS" in c and len(c["tRNS"]) >= 6:  # one transparent RGB colour
        key = np.array(struct.unpack(">HHH", c["tRNS"][:6]), img.dtype)
        alpha = np.where((img == key).all(2), 0, np.iinfo(img.dtype).max).astype(img.dtype)
        img = np.concatenate([img, alpha[..., None]], 2)
    return np.ascontiguousarray(_to_rgb_order(img))


def imdecode_color(buf) -> np.ndarray | None:
    """A BGR frame of encoded bytes as the JAX server reads a request
    (cv2.imdecode(IMREAD_COLOR), None when it cannot decode): PNGs through
    `decode`, other formats through cv2 where it is installed. Raises
    ValueError for a PNG that is not valid, and ImportError naming cv2 for a
    body that is not a PNG on a machine without it."""
    if not len(buf):
        return None
    if is_png(buf):
        return decode(buf, color=True)
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the body is not a PNG; decoding other formats (JPEG, ...) needs "
                          "OpenCV (cv2), which is not installed") from e
    try:
        return cv2.imdecode(np.frombuffer(bytes(buf), np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
