"""Image files without OpenCV: PNG, PGM/PPM and PFM readers and writers,
cv2's grey conversion and the integer-factor ``INTER_LINEAR`` downscale, in
numpy and ``zlib``.

The JAX package reads every image through ``cv2.imread`` / ``cvtColor`` /
``resize`` (bpvo_tpu/data/dataset.py:40-45, :125-127, :163-173) and writes
them with ``cv2.imwrite`` (bpvo_tpu/data/synthetic.py:843-872).  The GPU
machine the port targets has neither OpenCV nor PIL, so the port always
reads through this module; the tests hold it to cv2 bit for bit.

Conventions follow ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: 2-D arrays
for grey images, colour as BGR / BGRA, uint8 or uint16 samples, float32 for
PFM, and ``None`` for a file that does not exist.

PNG decoding undoes the five row filters vectorised: rows that only use
None / Sub / Up are undone row by row (Sub as a per-lane cumulative sum mod
256); once any row uses Average or Paeth, whose predictor depends on the
reconstructed left neighbour, the image is undone along anti-diagonals:
pixel (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), so every pixel with
x + y = t is independent of the others, and W + H - 1 vector steps
reconstruct the image.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}       # grey, RGB, RGBA
# cv2's BGR2GRAY fixed-point weights (0.114, 0.587, 0.299 in 1/2^15), the
# rule OpenCV 5 applies to 8- and 16-bit samples alike
_GRAY_B, _GRAY_G, _GRAY_R, _GRAY_SHIFT = 3735, 19235, 9798, 15


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def imread(path: str) -> Optional[np.ndarray]:
    """The image at ``path`` as cv2's ``IMREAD_UNCHANGED`` gives it, or None
    when the file does not exist.  PNG (8/16-bit grey, RGB, RGBA, not
    interlaced), PGM/PPM (P5/P6, 8/16-bit) and grey PFM; anything else
    raises ValueError."""
    if not path or not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data)
    if data[:2] == b"Pf":
        return decode_pfm(data)
    raise ValueError(f"{path}: not a PNG, binary PGM/PPM or grey PFM file")


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, 3|4) array (BGR / BGRA order)."""
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not "
                         "supported (grey, RGB, RGBA at 8 or 16 bits)")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError("interlaced or non-standard PNG is not supported")
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W * bpp + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{H * (W * bpp + 1)}")
    rows = raw.reshape(H, W * bpp + 1)
    pix = _unfilter(rows[:, 0], rows[:, 1:], bpp)          # (H, W, bpp)
    if depth == 16:
        pix = pix.reshape(H, W, channels, 2)
        img = (pix[..., 0].astype(np.uint16) << 8) | pix[..., 1]
    else:
        img = pix.reshape(H, W, channels)
    if channels == 1:
        return np.ascontiguousarray(img[..., 0])
    order = [2, 1, 0] if channels == 3 else [2, 1, 0, 3]     # RGB(A) -> BGR(A)
    return np.ascontiguousarray(img[..., order])


def _unfilter(ftype: np.ndarray, filtered: np.ndarray, bpp: int
              ) -> np.ndarray:
    """Undo the PNG row filters: (H,) filter types and (H, W * bpp)
    filtered bytes -> (H, W, bpp) uint8 samples."""
    H = filtered.shape[0]
    W = filtered.shape[1] // bpp
    if H == 0 or W == 0:
        return np.zeros((H, W, bpp), np.uint8)
    if ftype.max() > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not defined")
    F = filtered.reshape(H, W, bpp)
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up: each row at once
        out = np.empty((H, W, bpp), np.uint8)
        prev = np.zeros((W, bpp), np.uint8)
        for y in range(H):
            f = ftype[y]
            if f == 1:
                row = np.cumsum(F[y], axis=0, dtype=np.uint8)  # wraps mod 256
            elif f == 2:
                row = F[y] + prev
            else:
                row = F[y]
            out[y] = row
            prev = row
        return out
    # Average / Paeth: along anti-diagonals t = x + y.  S[t + 2, y + 1] holds
    # pixel (y, t - y); S[.., 0] (above row 0) and the steps before a row's
    # first pixel stay 0, the padding the PNG predictors assume.  Each step
    # is a fixed handful of numpy calls on preallocated (H, bpp) buffers:
    # the loop is bound by the calls, not by the arithmetic
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    n_steps = W + H - 1
    Fs = np.zeros((n_steps, H, bpp), np.int16)
    Fs[xx + yy, yy] = F
    S = np.zeros((n_steps + 2, H + 1, bpp), np.int16)
    masks = [(k, ftype[:, None] == k) for k in (1, 2, 3, 4)
             if (ftype == k).any()]
    only_paeth = bool((ftype == 4).all())
    d1, d2, d3, pred, avg = (np.empty((H, bpp), np.int16) for _ in range(5))
    m1, m2 = np.empty((H, bpp), bool), np.empty((H, bpp), bool)
    paeth = pred if only_paeth else np.empty((H, bpp), np.int16)
    for t in range(n_steps):
        a = S[t + 1, 1:]          # left:     (y, x - 1), step t - 1
        b = S[t + 1, :-1]         # up:       (y - 1, x), step t - 1
        c = S[t, :-1]             # up-left:  (y - 1, x - 1), step t - 2
        if only_paeth or any(k == 4 for k, _ in masks):
            # p = a + b - c; the nearest of a, b, c to p, ties in that order
            np.subtract(b, c, out=d1)
            np.subtract(a, c, out=d2)
            np.add(d1, d2, out=d3)
            np.abs(d1, out=d1)                     # |p - a|
            np.abs(d2, out=d2)                     # |p - b|
            np.abs(d3, out=d3)                     # |p - c|
            np.less_equal(d2, d3, out=m2)
            np.less_equal(d1, d2, out=m1)
            m1 &= d1 <= d3
            np.copyto(paeth, c)
            np.copyto(paeth, b, where=m2)
            np.copyto(paeth, a, where=m1)
        if not only_paeth:
            pred.fill(0)
            for k, m in masks:
                if k == 3:
                    np.add(a, b, out=avg)
                    avg >>= 1
                np.copyto(pred, (a, b, avg, paeth)[k - 1], where=m)
        out = S[t + 2, 1:]
        np.add(Fs[t], pred, out=out)
        out &= 255
    return S[xx + yy + 2, yy + 1].astype(np.uint8)


def _pnm_tokens(data: bytes, n: int):
    """The first ``n`` header tokens of a PNM file (``#`` comments skipped)
    and the offset just past the single whitespace after the last one."""
    tokens, pos = [], 0
    while len(tokens) < n:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b"\r", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    return tokens, pos + 1


def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) bytes -> (H, W) or (H, W, 3) BGR array,
    uint8 for maxval < 256, else big-endian uint16."""
    (magic, w, h, maxval), off = _pnm_tokens(data, 4)
    W, H, maxval = int(w), int(h), int(maxval)
    channels = 3 if magic == b"P6" else 1
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = W * H * channels
    img = np.frombuffer(data, dtype, count=n, offset=off)
    img = img.astype(dtype.newbyteorder("=")).reshape(
        (H, W, channels) if channels == 3 else (H, W))
    return np.ascontiguousarray(img[..., ::-1]) if channels == 3 else img


def decode_pfm(data: bytes) -> np.ndarray:
    """Grey PFM bytes -> (H, W) float32 (rows stored bottom-up; a negative
    scale means little-endian)."""
    (magic, w, h, scale), off = _pnm_tokens(data, 4)
    if magic != b"Pf":
        raise ValueError("not a grey PFM")
    W, H = int(w), int(h)
    arr = np.frombuffer(data, "<f4" if float(scale) < 0 else ">f4",
                        count=W * H, offset=off)
    return arr.reshape(H, W)[::-1].astype(np.float32)


def read_pfm(path: str) -> np.ndarray:
    """(bpvo_tpu/data/synthetic.py:482-491)"""
    with open(path, "rb") as f:
        return decode_pfm(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` by the file's extension: ``.png`` (uint8/uint16 grey,
    BGR, BGRA), ``.pgm``/``.ppm`` (uint8/uint16 grey or BGR), ``.pfm``
    (float32 grey)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png(img)
    elif ext in (".pgm", ".ppm", ".pnm"):
        data = encode_pnm(img)
    elif ext == ".pfm":
        write_pfm(path, img)
        return
    else:
        raise ValueError(f"{path}: cannot write {ext!r} files")
    with open(path, "wb") as f:
        f.write(data)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8/uint16 grey (H, W), BGR or BGRA (H, W, 3|4) -> PNG bytes.
    Every row takes the Paeth filter (computed from the unfiltered image,
    so at once for the whole image)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got "
                         f"{img.dtype}")
    if img.ndim == 2:
        rgb, ctype = img[..., None], 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        order = [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]
        rgb, ctype = img[..., order], 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot write a PNG of shape {img.shape}")
    H, W, channels = rgb.shape
    depth = 8 * img.dtype.itemsize
    bpp = channels * img.dtype.itemsize
    byte_rows = np.ascontiguousarray(rgb.astype(rgb.dtype.newbyteorder(">"))
                                     ).view(np.uint8).reshape(H, W, bpp)
    x = byte_rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = ((x - pred) & 255).astype(np.uint8).reshape(H, W * bpp)
    raw = np.concatenate([np.full((H, 1), 4, np.uint8), filtered], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def encode_pnm(img: np.ndarray) -> bytes:
    """uint8/uint16 grey (H, W) -> P5, BGR (H, W, 3) -> P6 (RGB samples);
    16-bit samples big-endian."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNM samples must be uint8 or uint16, got "
                         f"{img.dtype}")
    if img.ndim == 3 and img.shape[2] == 3:
        magic, body = b"P6", img[..., ::-1]
    elif img.ndim == 2:
        magic, body = b"P5", img
    else:
        raise ValueError(f"cannot write a PNM of shape {img.shape}")
    maxval = 255 if img.dtype == np.uint8 else 65535
    H, W = img.shape[:2]
    return (magic + f"\n{W} {H}\n{maxval}\n".encode()
            + np.ascontiguousarray(body.astype(body.dtype.newbyteorder(">"))
                                   ).tobytes())


def write_pfm(path: str, arr: np.ndarray) -> None:
    """Write a float32 grey PFM (bottom-up rows, little-endian)
    (bpvo_tpu/data/synthetic.py:470-480)."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2:
        raise ValueError(f"PFM: expected a 2-D array, got {arr.shape}")
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(arr[::-1]).astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# grey conversion and downscale
# ---------------------------------------------------------------------------

def to_gray(img: np.ndarray) -> np.ndarray:
    """cv2's ``COLOR_BGR2GRAY`` / ``BGRA2GRAY``: for integer samples the
    fixed-point rule (B*3735 + G*19235 + R*9798 + 2^14) >> 15; a 2-D image
    is returned as it is."""
    if img.ndim == 2:
        return img
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"to_gray: unsupported shape {img.shape}")
    if img.dtype in (np.uint8, np.uint16):
        b, g, r = (img[..., k].astype(np.int64) for k in range(3))
        y = (b * _GRAY_B + g * _GRAY_G + r * _GRAY_R
             + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
        return y.astype(img.dtype)
    f = img.astype(np.float32)
    return (f[..., 0] * np.float32(0.114) + f[..., 1] * np.float32(0.587)
            + f[..., 2] * np.float32(0.299)).astype(img.dtype)


def downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """``cv2.resize(img, None, fx=1/factor, fy=1/factor)`` (INTER_LINEAR) at
    an integer ``factor``: destination pixel d samples the source at
    factor*d + (factor-1)/2, so an odd factor picks one pixel and an even
    one averages the 2x2 block at factor*d + factor/2 - {1, 0} (clamped at
    the border).  uint8 rounds the mean half up, as cv2's fixed point does
    (at factor 2 half to even where the border clamps a row or a column,
    as its area path does there); uint16 averages in float32 and rounds
    half to even, as cv2 does.  Other sample types raise."""
    if factor == 1:
        return img
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"downscale: uint8 or uint16 samples, got "
                         f"{img.dtype}")
    if factor < 1 or int(factor) != factor:
        raise ValueError(f"downscale: factor must be a positive integer, "
                         f"got {factor}")
    H, W = img.shape[:2]
    h, w = round(H / factor), round(W / factor)

    def taps(n, size):
        lo = factor * np.arange(n) + (factor - 1) // 2
        hi = lo + (1 if factor % 2 == 0 else 0)
        return np.minimum(lo, size - 1), np.minimum(hi, size - 1)

    (y0, y1), (x0, x1) = taps(h, H), taps(w, W)
    if factor % 2:
        return np.ascontiguousarray(img[y0][:, x0])
    if img.dtype == np.uint8:
        s = (img[y0][:, x0].astype(np.int32) + img[y0][:, x1]
             + img[y1][:, x0] + img[y1][:, x1])
        out = (s + 2) >> 2
        if factor == 2:
            # cv2 takes its area path at exactly 2x; where the border clamps
            # a row or a column (not both: a corner is one pixel, as above)
            # it rounds the mean of the two pixels, s / 4, half to even
            two = s >> 1
            even = (two >> 1) + (two & 1 & (two >> 1))
            edge = (y0 == y1)[:, None] ^ (x0 == x1)[None, :]
            out = np.where(edge, even, out)
        return out.astype(np.uint8)
    f = img.astype(np.float32)
    half = np.float32(0.5)
    r0 = f[y0][:, x0] * half + f[y0][:, x1] * half
    r1 = f[y1][:, x0] * half + f[y1][:, x1] * half
    return np.rint(r0 * half + r1 * half).astype(np.uint16)
