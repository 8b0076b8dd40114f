"""Banded bilinear sampling and its five parts: the kernels of
``csrc/probe_band.cu``, their wrappers and their plain PyTorch versions
(counterpart of ``probe_gather_variants._band_kernel`` and of
``scripts/probe_band_bisect.py``).

``band_bilinear(u, v, img)`` samples N points in blocks of 1024: each block
reads only the 32-row band starting at min(min(floor v), H - 32), and a
point whose rows leave the band samples the band's last two rows instead
(the TPU kernel's clipping, kept; ``wide_points`` makes most points leave
it).  ``staged=True`` copies the band into shared memory first;
``staged=False`` reads the same taps from device memory.  v1-v5 are the
(8, 128) outputs of the band kernel's parts that the TPU bisection compiled
one by one; the port computes them directly, with no one-hot matrices
(those stood in for Mosaic's missing gather).

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from bpvo_tpu_torch.ops import _build
from bpvo_tpu_torch.probes._common import (MAX_SMEM_BYTES, LaunchCounts,
                                           compare, on_cpu, ptr, record,
                                           stream)
from bpvo_tpu_torch.probes.timing import times

H, W = 384, 1280
BAND = 32
BLOCK = 1024
OUT = (8, 128)
# kernel vs plain version on the same device: every product and sum is
# rounded in the plain version's order (bitwise); held at BAND_ATOL, the
# tolerance against the TPU kernel, whose one-hot products add exact zeros
BAND_ATOL = 1e-6

launch_count = LaunchCounts("band_bilinear", "band_bilinear_global",
                            "band_v1_static_slice", "band_v2_dyn_slice",
                            "band_v3_onehot", "band_v4_onehot_matmul",
                            "band_v5_rowweight")


def _cols(u, width):
    xi = torch.floor(u).to(torch.int32).clamp(0, width - 2)
    return xi, u - xi.to(torch.float32)


def _lerp(a, b, f):
    return a * (1 - f) + b * f


def _band_taps(u, v, Hd, Wd, band, block):
    """Each point's top-left tap in its block's band (a flat index into the
    image), and its xf, yf."""
    xi, xf = _cols(u, Wd)
    yi = torch.floor(v).to(torch.int32).clamp(0, Hd - 2)
    yf = v - yi.to(torch.float32)
    base = yi.reshape(-1, block).amin(1).clamp(max=Hd - band)
    base = base.repeat_interleave(block)
    row = base + (yi - base).clamp(0, band - 2)
    return (row * Wd + xi).long(), xf, yf


def band_bilinear_reference(u, v, img, band=BAND, block=BLOCK):
    """Banded bilinear samples of ``img`` (H, W) at points (u, v) of shape
    (N,), N a multiple of ``block``."""
    Hd, Wd = img.shape
    top, xf, yf = _band_taps(u, v, Hd, Wd, band, block)
    flat = img.reshape(-1)
    c0 = _lerp(flat[top], flat[top + 1], xf)
    c1 = _lerp(flat[top + Wd], flat[top + Wd + 1], xf)
    return _lerp(c0, c1, yf)


def bilinear_reference(u, v, img):
    """Unbanded bilinear samples (the JAX script's ``_maxerr`` reference)."""
    Hd, Wd = img.shape
    xi, xf = _cols(u, Wd)
    yi = torch.floor(v).to(torch.int32).clamp(0, Hd - 2)
    yf = v - yi.to(torch.float32)
    flat = img.reshape(-1)
    top = (yi * Wd + xi).long()
    return _lerp(_lerp(flat[top], flat[top + 1], xf),
                 _lerp(flat[top + Wd], flat[top + Wd + 1], xf), yf)


def band_bilinear(u, v, img, band=BAND, block=BLOCK, staged=True):
    """``band_bilinear_reference``, one CTA per block of 1024 points; the
    band staged in shared memory (``staged``) or read from device memory."""
    n = u.shape[0] if u.dim() == 1 else -1
    if block != BLOCK or n < 0 or n % block or v.shape != u.shape or (
            img.dim() != 2 or img.shape[0] < band or img.shape[1] < 2):
        raise ValueError(f"band_bilinear: points (N,) with N a multiple of "
                         f"{BLOCK}, img (H >= {band}, W), got {tuple(u.shape)}"
                         f", {tuple(v.shape)}, {tuple(img.shape)}")
    if on_cpu("band_bilinear", u, v, img):
        return band_bilinear_reference(u, v, img, band, block)
    Hd, Wd = img.shape
    if staged and band * Wd * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"band_bilinear: a band of {band} x {Wd} floats "
                         f"exceeds one CTA's shared memory")
    _build.check_tensors("band_bilinear", u.device, {
        "u": (u, (n,), torch.float32), "v": (v, (n,), torch.float32),
        "img": (img, (Hd, Wd), torch.float32)})
    lib = _build.library()
    out = torch.empty_like(u)
    _build.launch(lib, "band_bilinear", lib.bpvo_probe_band_bilinear(
        ptr(u), ptr(v), ptr(img), ptr(out), n, Hd, Wd, band, int(staged),
        stream(u.device)))
    launch_count["band_bilinear" if staged else "band_bilinear_global"] += 1
    return out


# ---------------------------------------------------------------------------
# v1-v5: the band kernel's parts, (8, 128) outputs
# ---------------------------------------------------------------------------

def _band_sum(img, base, band):
    rows = base + torch.arange(band, device=img.device)
    return img.index_select(0, rows).sum().expand(OUT).contiguous()


def static_slice_sum_reference(img, band=BAND):
    """v1: sum(img[0:band]) broadcast to (8, 128)."""
    return _band_sum(img, torch.zeros((), dtype=torch.int64,
                                      device=img.device), band)


def dyn_slice_sum_reference(v, img, band=BAND):
    """v2: the band sum at base = min(min(floor v), H - band), clamped to
    [0, H - band] as ``dynamic_slice`` clamps its start."""
    base = torch.floor(v).to(torch.int64).amin().clamp(
        max=img.shape[0] - band).clamp(min=0)
    return _band_sum(img, base, band)


def onehot_slice_reference(u, width=W):
    """v3: rows 0-7 (columns c) and points 0-127 of the 2-hot x matrix:
    1 - xf where c = xi, xf where c = xi + 1, else 0."""
    xi, xf = _cols(u[:OUT[1]], width)
    c = torch.arange(OUT[0], device=u.device, dtype=torch.int32)[:, None]
    zero = torch.zeros((), device=u.device)
    return torch.where(c == xi, 1 - xf, torch.where(c == xi + 1, xf, zero))


def onehot_matmul_slice_reference(u, img):
    """v4: (band @ 2-hot)[:8, :128] = (1 - xf) img[i, xi] + xf img[i, xi+1]."""
    xi, xf = _cols(u[:OUT[1]], img.shape[1])
    rows = img[:OUT[0]]
    return _lerp(rows[:, xi.long()], rows[:, xi.long() + 1], xf)


def rowweight_reference(v, img, band=BAND):
    """v5: (1 - yf) img[rel, 0] + yf img[rel + 1, 0] for the first 128
    points, rel = clip(floor v, 0, band - 2), broadcast to (8, 128)."""
    v = v[:OUT[1]]
    yi = torch.floor(v).to(torch.int32)
    yf = v - yi.to(torch.float32)
    rel = yi.clamp(0, band - 2).long()
    col = img[:, 0]
    return _lerp(col[rel], col[rel + 1], yf).expand(OUT).contiguous()


def _part(name, fn, want, *args):
    """Launch one of v1-v5 on CUDA tensors: ``fn(*args, out, stream)``
    with each tensor of ``args`` passed by pointer; ``want`` maps tensor
    names to (tensor, shape) for the checks."""
    dev = next(iter(want.values()))[0].device
    _build.check_tensors(name, dev, {k: (t, s, torch.float32)
                                     for k, (t, s) in want.items()})
    lib = _build.library()
    out = torch.empty(OUT, dtype=torch.float32, device=dev)
    _build.launch(lib, name, getattr(lib, fn)(
        *(ptr(a) if isinstance(a, torch.Tensor) else a for a in args),
        ptr(out), stream(dev)))
    launch_count[name] += 1
    return out


def _check_img(op, img, rows):
    if img.dim() != 2 or img.shape[0] < rows or img.shape[1] < 2:
        raise ValueError(f"{op}: img must be (H >= {rows}, W >= 2), got "
                         f"{tuple(img.shape)}")


def _check_points(op, x, least):
    if x.dim() != 1 or x.shape[0] < least:
        raise ValueError(f"{op}: points must be (n >= {least},), got "
                         f"{tuple(x.shape)}")


def static_slice_sum(img, band=BAND):
    _check_img("static_slice_sum", img, band)
    if on_cpu("static_slice_sum", img):
        return static_slice_sum_reference(img, band)
    Hd, Wd = img.shape
    return _part("band_v1_static_slice", "bpvo_probe_band_static_slice",
                 {"img": (img, (Hd, Wd))}, img, Hd, Wd, band)


def dyn_slice_sum(v, img, band=BAND):
    _check_img("dyn_slice_sum", img, band)
    _check_points("dyn_slice_sum", v, 1)
    if on_cpu("dyn_slice_sum", v, img):
        return dyn_slice_sum_reference(v, img, band)
    Hd, Wd = img.shape
    return _part("band_v2_dyn_slice", "bpvo_probe_band_dyn_slice",
                 {"v": (v, v.shape), "img": (img, (Hd, Wd))}, v, v.shape[0],
                 img, Hd, Wd, band)


def onehot_slice(u, width=W):
    _check_points("onehot_slice", u, OUT[1])
    if on_cpu("onehot_slice", u):
        return onehot_slice_reference(u, width)
    return _part("band_v3_onehot", "bpvo_probe_band_onehot",
                 {"u": (u, u.shape)}, u, width)


def onehot_matmul_slice(u, img):
    _check_points("onehot_matmul_slice", u, OUT[1])
    _check_img("onehot_matmul_slice", img, OUT[0])
    if on_cpu("onehot_matmul_slice", u, img):
        return onehot_matmul_slice_reference(u, img)
    return _part("band_v4_onehot_matmul", "bpvo_probe_band_onehot_matmul",
                 {"u": (u, u.shape), "img": (img, img.shape)}, u, img,
                 img.shape[1])


def rowweight(v, img, band=BAND):
    _check_points("rowweight", v, OUT[1])
    _check_img("rowweight", img, band)
    if on_cpu("rowweight", v, img):
        return rowweight_reference(v, img, band)
    return _part("band_v5_rowweight", "bpvo_probe_band_rowweight",
                 {"v": (v, v.shape), "img": (img, img.shape)}, v, img,
                 img.shape[1], band)


def bisect_inputs(seed=0):
    """probe_band_bisect.py's data, drawn in its order: the H x W
    standard-normal image and one block of points, U uniform in [2, W - 4),
    V sorted uniform in [2, 30) (numpy float32; the TPU kernels took them
    as 8 broadcast rows)."""
    rng = np.random.default_rng(seed)
    IMG = rng.standard_normal((H, W)).astype(np.float32)
    U = rng.uniform(2, W - 4, BLOCK).astype(np.float32)
    V = np.sort(rng.uniform(2, 30, BLOCK)).astype(np.float32)
    return IMG, U, V


def wide_points(n, seed=1):
    """n points (U, V) uniform over the whole H x W image (numpy float32):
    each block of 1024 spans far more rows than a band, so most of its points
    sample the band's clipped rows."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, W - 1, n).astype(np.float32),
            rng.uniform(0, H - 1, n).astype(np.float32))


def integer_image(seed=0):
    """An H x W image of small integers: v1 and v2 sum 40960 of its values,
    exactly in any order, so kernel and plain version agree bit for bit."""
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (H, W)).astype(np.float32)


# ---------------------------------------------------------------------------
# the scripts' steps, timed
# ---------------------------------------------------------------------------

def band_step(points):
    """probe_gather_variants.py's band step on its points (``"script"``) or
    on ``wide_points`` (``"wide"``): both variants against the plain version
    and timed, beside the plain version and ``F.grid_sample`` (unbanded), with
    the largest difference from unbanded bilinear sampling (points whose rows
    leave their block's band) and the work ("bytes": u, v, the output and
    each distinct tap once; "ops": ~15 per point)."""
    def step(device, data):
        import torch.nn.functional as F
        _, U, V, IMG = data
        if points == "wide":
            U, V = wide_points(len(U))
        u, v, img = (torch.as_tensor(a, device=device) for a in (U, V, IMG))
        Hd, Wd = img.shape
        want = band_bilinear_reference(u, v, img)
        top, _, _ = _band_taps(u, v, Hd, Wd, BAND, BLOCK)
        taps = torch.unique(torch.cat([top, top + 1, top + Wd,
                                       top + Wd + 1])).numel()
        grid = torch.stack([u / (Wd - 1) * 2 - 1, v / (Hd - 1) * 2 - 1],
                           -1)[None, None]
        out = {**times(lambda: band_bilinear_reference(u, v, img), device,
                       "plain_"),
               **times(lambda: F.grid_sample(
                   img[None, None], grid, mode="bilinear",
                   padding_mode="zeros", align_corners=True), device,
                   "library_"),
               "maxerr_vs_unbanded": float(
                   (want - bilinear_reference(u, v, img)).abs().max()),
               "bytes": 3 * 4 * u.numel() + 4 * taps, "ops": 15 * u.numel()}
        for name, staged in (("staged", True), ("global", False)):
            def one(staged=staged):
                got = band_bilinear(u, v, img, staged=staged)
                return {**compare(got, want, atol=BAND_ATOL),
                        **times(lambda: band_bilinear(u, v, img,
                                                      staged=staged), device)}
            record(out, name, one)
        return out
    return step


PARTS = (  # name, kernel wrapper, plain version, inputs, exact
    ("v1_static_slice", static_slice_sum, static_slice_sum_reference,
     ("int_img",), True),
    ("v2_dyn_slice", dyn_slice_sum, dyn_slice_sum_reference,
     ("v", "int_img"), True),
    ("v3_onehot", onehot_slice, onehot_slice_reference, ("u",), True),
    ("v4_onehot_matmul", onehot_matmul_slice, onehot_matmul_slice_reference,
     ("u", "img"), False),
    ("v5_rowweight", rowweight, rowweight_reference, ("v", "img"), False))


def part_inputs(device, seed=0):
    """probe_band_bisect.py's inputs on ``device``, plus the integer image
    that v1 and v2 sum."""
    IMG, U, V = bisect_inputs(seed)
    return {k: torch.as_tensor(a, device=device) for k, a in (
        ("img", IMG), ("u", U), ("v", V), ("int_img", integer_image(seed)))}


def _part_work(name, data):
    """(bytes, f32 operations, library call or None) of one of v1-v5 on
    ``data``: each input read once (for v4 and v5 only the columns or rows
    that the 128 points touch), the (8, 128) output written once."""
    out = 4 * OUT[0] * OUT[1]
    band_bytes = 4 * BAND * data["img"].shape[1]
    pts = data["u"].shape[0]
    Wd = data["img"].shape[1]
    cols = torch.floor(data["u"][:OUT[1]]).long().clamp(0, Wd - 2)
    rows = torch.floor(data["v"][:OUT[1]]).long().clamp(0, BAND - 2)
    n_cols = torch.unique(torch.cat([cols, cols + 1])).numel()
    n_rows = torch.unique(torch.cat([rows, rows + 1])).numel()
    return {
        "v1_static_slice": (band_bytes + out, BAND * Wd,
                            lambda: data["int_img"][:BAND].sum()),
        "v2_dyn_slice": (4 * pts + band_bytes + out, BAND * Wd + pts, None),
        "v3_onehot": (4 * OUT[1] + out, 3 * OUT[0] * OUT[1], None),
        "v4_onehot_matmul": (4 * OUT[1] + out + 4 * OUT[0] * n_cols,
                             3 * OUT[0] * OUT[1], None),
        "v5_rowweight": (4 * OUT[1] + out + 4 * n_rows,
                         3 * OUT[0] * OUT[1], None)}[name]


def _part_step(name, kernel, plain, keys, exact):
    def step(device, data):
        args = tuple(data[k] for k in keys)
        got, want = kernel(*args), plain(*args)
        nbytes, ops, library = _part_work(name, data)
        return {**compare(got, want, atol=0.0 if exact else BAND_ATOL),
                "sample": got[0, :3].tolist(),
                **times(lambda: kernel(*args), device),
                **times(lambda: plain(*args), device, "plain_"),
                **(times(library, device, "library_") if library else
                   {"library_ms": None}),
                "bytes": nbytes, "ops": ops}
    return step


STEPS = tuple((p[0], _part_step(*p)) for p in PARTS)
