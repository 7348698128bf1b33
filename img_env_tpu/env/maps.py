"""Static map loading (host side, once per environment construction).

Replicates ``GridMap::read_image`` (grid_map.cpp:28-38): the PNG is read as
grayscale and resampled from its native ``global_resolution`` to the view
resolution with bilinear interpolation (cv2 default).  Row index corresponds
to world x, column index to world y (``world2map``: m = round(x/res),
n = round(y/res), grid_map.cpp:40-44).

The PNG decoder and the resize are plain numpy (zlib from the standard
library), so the simulator needs no image package; both reproduce what
``cv2.imread(..., IMREAD_GRAYSCALE)`` + ``cv2.resize`` give for the maps
(tests/test_maps.py checks every committed map against cv2).
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

from img_env_tpu.config import EnvConfig

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG colour type -> samples/pixel
_COEF_BITS = 11                          # cv2 INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (RFC 2083 §6)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            # Sub, Average and Paeth depend on the reconstructed left
            # neighbour: walk the row (maps are small, host-side, once)
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + b) >> 1
                elif ftype == 4:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x] = (line[x] + p) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png_gray(path: str) -> np.ndarray:
    """uint8 [H, W] grayscale image of an 8-bit, non-interlaced PNG.

    Colour pixels convert like libpng's rgb_to_gray as cv2 sets it up
    (truncating fixed-point 0.299/0.587/0.114 weights; a pixel with
    R == G == B keeps its value exactly); alpha is dropped.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are "
            f"supported (depth={depth}, colour type={color}, "
            f"interlace={interlace})")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch <= 2:
        return np.ascontiguousarray(px[..., 0])
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    gray = (9797 * r + 19234 * g + 3737 * b) >> 15
    same = (r == g) & (g == b)
    return np.where(same, r, gray).astype(np.uint8)


def _linear_taps(dst: int, src: int):
    """cv2 INTER_LINEAR source index pair and 11-bit fixed-point weights
    per destination index (resize.cpp's coefficient setup: float
    coordinate, border clamp, round-to-nearest weights)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    lo, hi = s < 0, s >= src - 1
    f[lo | hi] = 0.0
    s[lo] = 0
    s[hi] = src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """numpy port of ``cv2.resize(img, (width, height))`` for uint8 gray
    images (INTER_LINEAR, fixed point).

    Horizontal pass: ``S = I[x0] * a0 + I[x1] * a1`` (ints scaled by 2^11).
    Vertical pass as cv2's vectorised uint8 kernel computes it:
    ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``, rounded by
    ``(v + 2) >> 2``.  Exact on the committed maps; on arbitrary gray
    images cv2's scalar row tails may differ by one level.
    """
    if img.shape == (height, width):
        return img.copy()
    x0, x1, a0, a1 = _linear_taps(width, img.shape[1])
    y0, y1, b0, b1 = _linear_taps(height, img.shape[0])
    im = img.astype(np.int64)
    hor = im[:, x0] * a0 + im[:, x1] * a1
    v = ((((hor[y0] >> 4) * b0[:, None]) >> 16)
         + (((hor[y1] >> 4) * b1[:, None]) >> 16))
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=32)
def _load_resized(path: str, global_res: float, view_res: float) -> np.ndarray:
    img = read_png_gray(path)
    h = int(img.shape[0] * global_res / view_res)
    w = int(img.shape[1] * global_res / view_res)
    return resize_linear_u8(img, w, h)


def load_static_map(cfg: EnvConfig) -> np.ndarray:
    """uint8 [H, W] occupancy at ``view_map_resolution``."""
    return _load_resized(
        cfg.resolve_map_path(), float(cfg.global_resolution), float(cfg.view_map_resolution)
    )


def map_extent_m(static_map: np.ndarray, resolution: float) -> tuple:
    """(x_extent, y_extent) in meters."""
    return static_map.shape[0] * resolution, static_map.shape[1] * resolution
