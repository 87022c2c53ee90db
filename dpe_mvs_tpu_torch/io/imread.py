"""Grayscale image reading and PNG writing without OpenCV.

The port's stand-in for ``cv2.imread(path, IMREAD_GRAYSCALE)`` and for the
``cv2.imwrite`` of the scene images. Like OpenCV it decodes by the file's
signature, not by its name (a dense folder's ``images/%08d.jpg`` may hold PNG
bytes):

  - PNG: 8-bit gray, RGB or RGBA, non-interlaced, decoded with
    ``zlib`` and numpy (all five row filters);
  - binary PGM / PPM (``P5`` / ``P6``), 8-bit;
  - JPEG: through Pillow, imported only when a JPEG is met, decoded
    straight to gray (libjpeg's luma output, as OpenCV asks for it).

Colour goes to gray as OpenCV's own decoders take it there: a PNG by
libpng's ``png_set_rgb_to_gray(0.299, 0.587)``, ``(R*9797 + G*19234 +
B*3737) >> 15``; a PPM by OpenCV's fixed-point ``BGR2GRAY``, ``(R*4899 +
G*9617 + B*1868 + 8192) >> 14``. Alpha is dropped. Any other format raises
``ValueError`` naming it; nothing falls back silently.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples per pixel


def _gray_png(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> uint8 gray, libpng's truncating rule."""
    c = rgb.astype(np.int32)
    return ((c[..., 0] * 9797 + c[..., 1] * 19234 + c[..., 2] * 3737)
            >> 15).astype(np.uint8)


def _gray_cv(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> uint8 gray, OpenCV's rounding rule."""
    c = rgb.astype(np.int32)
    return ((c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868 + 8192)
            >> 14).astype(np.uint8)


def _paeth_row(line: bytearray, prev: bytes, bpp: int,
               average: bool) -> None:
    """Undo the Average (3) or Paeth (4) filter of one row in place: both
    depend on the reconstructed byte to the left, so they run per byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if average:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _decode_png(data: bytes, path) -> np.ndarray:
    pos = len(_PNG_SIG)
    ihdr = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    W, H, depth, ctype, _comp, _filt, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); 8-bit non-interlaced gray, "
            f"RGB or RGBA only")
    bpp = _PNG_CHANNELS[ctype]
    stride = W * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (stride + 1):
        raise ValueError(f"{path}: PNG data of {len(raw)} bytes, expected "
                         f"{H * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:                       # Sub: running sum per channel
            cur = (np.cumsum(line.reshape(W, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(stride)
        elif kind == 2:                       # Up
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp, average=kind == 3)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    if bpp == 1:
        return out
    return _gray_png(out.reshape(H, W, bpp)[..., :3])


def _pnm_tokens(data: bytes, n: int):
    """The first n whitespace-separated header tokens of a PNM file (comments
    skipped) and the offset of the byte after the last one's delimiter."""
    tokens, pos = [], 0
    while len(tokens) < n:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PNM header")
        tokens.append(data[start:pos])
    return tokens, pos + 1


def _decode_pnm(data: bytes, path) -> np.ndarray:
    (magic, w, h, maxval), pos = _pnm_tokens(data, 4)
    W, H, maxval = int(w), int(h), int(maxval)
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PNM (maxval {maxval})")
    ch = 1 if magic == b"P5" else 3
    px = np.frombuffer(data, np.uint8, count=W * H * ch, offset=pos)
    if ch == 1:
        return px.reshape(H, W).copy()
    return _gray_cv(px.reshape(H, W, 3))


def _decode_jpeg(path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is a JPEG: reading it needs Pillow "
                          "(the PIL package), which is not installed") from e
    with Image.open(path) as im:
        im.draft("L", im.size)
        return np.asarray(im.convert("L"), np.uint8).copy()


def read_gray_u8(path: os.PathLike) -> np.ndarray:
    """The image at ``path`` as (H, W) uint8 gray, decoded by its
    signature. Raises FileNotFoundError if it is missing and ValueError for
    a format it does not read."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return _decode_png(data, path)
    if data[:2] in (b"P5", b"P6"):
        return _decode_pnm(data, path)
    if data.startswith(b"\xff\xd8\xff"):
        return _decode_jpeg(path)
    raise ValueError(f"{path}: not a PNG, binary PGM/PPM or JPEG file "
                     f"(starts with {data[:8]!r})")


def read_gray(path: os.PathLike) -> np.ndarray:
    """The image at ``path`` as (H, W) float32 gray in [0, 255]."""
    return read_gray_u8(path).astype(np.float32)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png_gray(path: os.PathLike, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit gray PNG: one IDAT, every
    row with filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png_gray takes (H, W) uint8, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0,
                                                  0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))
