"""Image reading and writing without OpenCV.

The port's stand-in for ``cv2.imread(path, IMREAD_GRAYSCALE)``,
``cv2.imread(path, IMREAD_COLOR)`` and the ``cv2.imwrite`` of scene, debug
and converted images. Like OpenCV it decodes by the file's signature, not by
its name (a dense folder's ``images/%08d.jpg`` may hold PNG bytes):

  - PNG: 8-bit gray, RGB or RGBA, non-interlaced, decoded with
    ``zlib`` and numpy (all five row filters);
  - binary PGM / PPM (``P5`` / ``P6``), 8-bit;
  - JPEG: through Pillow, imported only when a JPEG is met (gray straight
    from libjpeg's luma output, as OpenCV asks for it).

Gray reads take colour to gray as OpenCV's own decoders do: a PNG by
libpng's ``png_set_rgb_to_gray(0.299, 0.587)``, ``(R*9797 + G*19234 +
B*3737) >> 15``; a PPM by OpenCV's fixed-point ``BGR2GRAY``, ``(R*4899 +
G*9617 + B*1868 + 8192) >> 14``. Colour reads give BGR: a gray image's
one channel three times, alpha dropped. Any other format raises
``ValueError`` naming it; nothing falls back silently.

Writers: PNG (gray or BGR, filter 0 on every row) and JPEG at OpenCV's
default quality 95 through Pillow. :func:`jpeg_roundtrip_gray` gives, in
numpy, the pixels a gray image has after libjpeg's baseline encoder and
decoder (what ``cv2.imread`` returns for a file ``cv2.imwrite`` made).
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
    """The PNG's samples, (H, W, 1 | 3 | 4) uint8."""
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
    return out.reshape(H, W, bpp)


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
    """The PGM's or PPM's samples, (H, W, 1 | 3) uint8."""
    (magic, w, h, maxval), pos = _pnm_tokens(data, 4)
    W, H, maxval = int(w), int(h), int(maxval)
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PNM (maxval {maxval})")
    ch = 1 if magic == b"P5" else 3
    px = np.frombuffer(data, np.uint8, count=W * H * ch, offset=pos)
    return px.reshape(H, W, ch).copy()


def _pillow(path, action: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {action} a JPEG needs Pillow (the PIL "
                          "package), which is not installed") from e
    return Image


def _decode_jpeg(path, color: bool) -> np.ndarray:
    """Gray (H, W) or BGR (H, W, 3) uint8 from a JPEG, through Pillow."""
    Image = _pillow(path, "reading")
    with Image.open(path) as im:
        if not color:
            im.draft("L", im.size)
            return np.asarray(im.convert("L"), np.uint8).copy()
        if im.mode == "L":
            return np.repeat(np.asarray(im, np.uint8)[..., None], 3, axis=2)
        return np.ascontiguousarray(
            np.asarray(im.convert("RGB"), np.uint8)[..., ::-1])


def _read(path, color: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        px, gray = _decode_png(data, path), _gray_png
    elif data[:2] in (b"P5", b"P6"):
        px, gray = _decode_pnm(data, path), _gray_cv
    elif data.startswith(b"\xff\xd8\xff"):
        return _decode_jpeg(path, color)
    else:
        raise ValueError(f"{path}: not a PNG, binary PGM/PPM or JPEG file "
                         f"(starts with {data[:8]!r})")
    if px.shape[2] == 1:
        return np.repeat(px, 3, axis=2) if color else px[..., 0].copy()
    rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1]) if color else gray(rgb)


def read_gray_u8(path: os.PathLike) -> np.ndarray:
    """The image at ``path`` as (H, W) uint8 gray, decoded by its
    signature. Raises FileNotFoundError if it is missing and ValueError for
    a format it does not read."""
    return _read(path, color=False)


def read_color_u8(path: os.PathLike) -> np.ndarray:
    """The image at ``path`` as (H, W, 3) uint8 BGR, as ``cv2.imread(path,
    IMREAD_COLOR)`` gives it: gray replicated to three channels, alpha
    dropped. Raises as :func:`read_gray_u8` does."""
    return _read(path, color=True)


def read_gray(path: os.PathLike) -> np.ndarray:
    """The image at ``path`` as (H, W) float32 gray in [0, 255]."""
    return read_gray_u8(path).astype(np.float32)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write_png(path, rows: np.ndarray, ctype: int) -> None:
    """An 8-bit PNG of colour type ``ctype`` from (H, W * samples) uint8
    rows: one IDAT, every row with filter 0."""
    H, stride = rows.shape
    W = stride // {0: 1, 2: 3}[ctype]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                                  0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def write_png_gray(path: os.PathLike, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit gray PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png_gray takes (H, W) uint8, got "
                         f"{img.dtype} {img.shape}")
    _write_png(path, img, 0)


def _bgr(img: np.ndarray, name: str) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{name} takes (H, W, 3) uint8 BGR, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img[..., ::-1])


def write_png_color(path: os.PathLike, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image (OpenCV's order) as an 8-bit RGB
    PNG."""
    rgb = _bgr(img, "write_png_color")
    _write_png(path, rgb.reshape(rgb.shape[0], -1), 2)


def write_jpeg_color(path: os.PathLike, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as a baseline JPEG through Pillow,
    at ``cv2.imwrite``'s default quality, 95 (4:2:0 chroma, as OpenCV's
    default)."""
    rgb = _bgr(img, "write_jpeg_color")
    Image = _pillow(path, "writing")
    Image.fromarray(rgb, "RGB").save(path, "JPEG", quality=95)


# libjpeg's "islow" integer DCT (jfdctint.c, jidctint.c of libjpeg 6b, which
# libjpeg-turbo keeps bit for bit): 13 fraction bits in the constants, 2
# extra bits between the passes.
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0_298, _F0_390, _F0_541, _F0_765, _F0_899, _F1_175, _F1_501, _F1_847,
 _F1_961, _F2_053, _F2_562, _F3_072) = (2446, 3196, 4433, 6270, 7373, 9633,
                                       12299, 15137, 16069, 16819, 20995,
                                       25172)
# The JPEG standard's luminance table (natural order), which libjpeg scales
# by the quality.
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_islow(d: np.ndarray, last: bool) -> np.ndarray:
    """One pass of jpeg_fdct_islow over the last axis (8 samples)."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    if last:
        n = _CONST_BITS + _PASS1_BITS
        o0, o4 = _descale(t10 + t11, _PASS1_BITS), _descale(t10 - t11,
                                                            _PASS1_BITS)
    else:
        n = _CONST_BITS - _PASS1_BITS
        o0, o4 = (t10 + t11) << _PASS1_BITS, (t10 - t11) << _PASS1_BITS
    z1 = (t12 + t13) * _F0_541
    o2 = _descale(z1 + t13 * _F0_765, n)
    o6 = _descale(z1 - t12 * _F1_847, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1_175
    z3 = z5 - z3 * _F1_961
    z4 = z5 - z4 * _F0_390
    z1, z2 = -z1 * _F0_899, -z2 * _F2_562
    return np.stack([o0, _descale(t7 * _F1_501 + z1 + z4, n), o2,
                     _descale(t6 * _F3_072 + z2 + z3, n), o4,
                     _descale(t5 * _F2_053 + z2 + z4, n), o6,
                     _descale(t4 * _F0_298 + z1 + z3, n)], -1)


def _idct_islow(c: np.ndarray, last: bool) -> np.ndarray:
    """One pass of jpeg_idct_islow over the last axis (8 coefficients)."""
    z1 = (c[..., 2] + c[..., 6]) * _F0_541
    t2 = z1 - c[..., 6] * _F1_847
    t3 = z1 + c[..., 2] * _F0_765
    t0 = (c[..., 0] + c[..., 4]) << _CONST_BITS
    t1 = (c[..., 0] - c[..., 4]) << _CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    z3 = z5 - z3 * _F1_961
    z4 = z5 - z4 * _F0_390
    z1, z2 = -z1 * _F0_899, -z2 * _F2_562
    t0 = t0 * _F0_298 + z1 + z3
    t1 = t1 * _F2_053 + z2 + z4
    t2 = t2 * _F3_072 + z2 + z3
    t3 = t3 * _F1_501 + z1 + z4
    n = _CONST_BITS + _PASS1_BITS + 3 if last else _CONST_BITS - _PASS1_BITS
    return np.stack([_descale(t10 + t3, n), _descale(t11 + t2, n),
                     _descale(t12 + t1, n), _descale(t13 + t0, n),
                     _descale(t13 - t0, n), _descale(t12 - t1, n),
                     _descale(t11 - t2, n), _descale(t10 - t3, n)], -1)


def jpeg_roundtrip_gray(img: np.ndarray, quality: int) -> np.ndarray:
    """The (H, W) uint8 gray image as libjpeg's baseline codec gives it back
    at ``quality`` (``cv2.imread(p, IMREAD_GRAYSCALE)`` of
    ``cv2.imwrite(p, img, [IMWRITE_JPEG_QUALITY, quality])``): edge-padded
    to whole 8x8 blocks, islow forward DCT, libjpeg's rounding quantization
    by the quality-scaled luminance table, islow inverse DCT and its
    range-limit table. Lossless entropy coding is left out."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"jpeg_roundtrip_gray takes (H, W) uint8, got "
                         f"{img.dtype} {img.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} is not in 1..100")
    H, W = img.shape
    Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
    x = np.pad(img, ((0, Hp - H), (0, Wp - W)), mode="edge").astype(np.int64)
    blocks = (x - 128).reshape(Hp // 8, 8, Wp // 8, 8).transpose(0, 2, 1, 3)
    coef = _fdct_islow(blocks, False)                          # rows
    coef = _fdct_islow(coef.swapaxes(-1, -2), True).swapaxes(-1, -2)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = np.clip((_LUMA_QUANT * scale + 50) // 100, 1, 255)
    div = qt << 3                        # the DCT's output is 8x too large
    q = np.sign(coef) * ((np.abs(coef) + (div >> 1)) // div)
    out = _idct_islow((q * qt).swapaxes(-1, -2), False).swapaxes(-1, -2)
    out = _idct_islow(out, True) & 1023                         # rows
    # libjpeg's range-limit table, indexed by the low 10 bits.
    out = np.where(out < 512, np.minimum(out + 128, 255),
                   np.where(out < 896, 0, out - 896))
    return out.transpose(0, 2, 1, 3).reshape(Hp, Wp)[:H, :W] \
        .astype(np.uint8)
