"""Visualization helpers (counterpart of ``bpvo_tpu/utils/viz.py``;
reference ``utils/viz.{h,cc}``: colorizeDisparity / overlayDisparity, and
the VoApp viewer), on numpy without cv2.

``colorize_disparity`` looks up a 256-entry table equal to cv2's
``COLORMAP_JET``, built as OpenCV's colormap.cpp builds it;
``overlay_disparity`` blends as ``cv2.addWeighted`` does; the viewer's
headless dumps are written by ``data/imageio``.  Only a GUI window needs
cv2, and the viewer opens one only where ``$DISPLAY`` is set and cv2
imports.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from bpvo_tpu_torch.data import imageio


def _jet_table() -> np.ndarray:
    """(256, 3) uint8 BGR: cv2's COLORMAP_JET.  OpenCV defines jet as GNU
    Octave's (piecewise linear in x between the control points 1/8, 3/8,
    5/8, 7/8) sampled at 256 float32 points, resamples those samples with
    its ``interp1`` at ``linspace(0, 1, 256)`` in float32 (for x_i it
    interpolates between samples i-1 and i, which can move the last bit)
    and converts with ``saturate_cast`` (x 255, round half to even)."""
    x = np.linspace(0.0, 1.0, 256)
    b = ((x < 1 / 8) * (4 * x + 0.5) + ((x >= 1 / 8) & (x < 3 / 8))
         + ((x >= 3 / 8) & (x < 5 / 8)) * (-4 * x + 2.5))
    g = (((x >= 1 / 8) & (x < 3 / 8)) * (4 * x - 0.5)
         + ((x >= 3 / 8) & (x < 5 / 8))
         + ((x >= 5 / 8) & (x < 7 / 8)) * (-4 * x + 3.5))
    r = (((x >= 3 / 8) & (x < 5 / 8)) * (4 * x - 1.5)
         + ((x >= 5 / 8) & (x < 7 / 8)) + (x >= 7 / 8) * (-4 * x + 4.5))
    f32 = np.float32
    # OpenCV's linspace: x0 + i * step in float32
    xs = np.arange(256, dtype=f32) * (f32(1.0) / f32(255))
    # its binary search ends with X[low] < x_i <= X[high]
    high = np.maximum(np.searchsorted(xs, xs, side="left"), 1)
    low = high - 1
    planes = []
    for y in (b, g, r):
        y = y.astype(f32)
        v = y[low] + (xs - xs[low]) * (y[high] - y[low]) / (xs[high]
                                                            - xs[low])
        planes.append(np.clip(np.rint(v * f32(255)), 0, 255))
    return np.stack(planes, axis=1).astype(np.uint8)


JET_BGR = _jet_table()


def colorize_disparity(D: np.ndarray, min_d: float = 0.0,
                       max_d: float = None) -> np.ndarray:
    """float disparity -> BGR uint8 jet colorization; invalid (<= min_d)
    pixels black (reference viz.cc colorizeDisparity)."""
    valid = D > min_d
    if max_d is None:
        max_d = float(D[valid].max()) if valid.any() else 1.0
    norm = np.zeros_like(D, np.float32)
    norm[valid] = np.clip((D[valid] - min_d) / max(max_d - min_d, 1e-6), 0, 1)
    u8 = (norm * 255).astype(np.uint8)
    color = JET_BGR[u8]
    color[~valid] = 0
    return color


def overlay_disparity(image: np.ndarray, D: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """Blend the colorized disparity over the image (reference viz.cc
    overlayDisparity): grey to BGR, then ``cv2.addWeighted(image, 1 -
    alpha, color, alpha, 0)`` with cv2's arithmetic: float32 weights,
    ``fma(image, 1 - alpha, fma(color, alpha, 0))`` and ``saturate_cast``
    (round half to even)."""
    color = colorize_disparity(D)
    img_u8 = image.astype(np.uint8) if image.dtype != np.uint8 else image
    if img_u8.ndim == 2:
        img_u8 = np.repeat(img_u8[:, :, None], 3, axis=2)
    f32, f64 = np.float32, np.float64
    inner = (color.astype(f64) * f64(f32(alpha))).astype(f32)
    # a float64 product of a uint8 and a float32 weight plus a float32 is
    # exact, so one rounding to float32 is the fused multiply-add's
    blend = (img_u8.astype(f64) * f64(f32(1.0 - alpha))
             + inner.astype(f64)).astype(f32)
    return np.clip(np.rint(blend), 0, 255).astype(np.uint8)


# The HUD's bitmap font: 5x7 glyphs drawn 2x, on cv2.putText's baseline at
# (8, 22) with FONT_HERSHEY_SIMPLEX at scale 0.6 (cap height ~13 px,
# advance ~12 px), the box JAX's viewer writes its HUD into
HUD_ORIGIN = (8, 22)           # (x, baseline y), as JAX's putText
HUD_SCALE = 2
HUD_ADVANCE = 6 * HUD_SCALE
_GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    "#": ("01010", "01010", "11111", "01010", "11111", "01010", "01010"),
    ".": ("00000", "00000", "00000", "00000", "00000", "01100", "01100"),
    "H": ("10001", "10001", "10001", "11111", "10001", "10001", "10001"),
    "z": ("00000", "00000", "11111", "00010", "00100", "01000", "11111"),
    "K": ("10001", "10010", "10100", "11000", "10100", "10010", "10001"),
    "F": ("11111", "10000", "10000", "11110", "10000", "10000", "10000"),
    " ": ("00000",) * 7,
}
_GLYPH_MASKS = {c: np.kron(np.array([[ch == "1" for ch in row]
                                     for row in rows]),
                           np.ones((HUD_SCALE, HUD_SCALE), bool))
                for c, rows in _GLYPHS.items()}


def hud_box(text: str):
    """(row0, row1, col0, col1) of the pixels ``draw_hud`` may write."""
    x, y = HUD_ORIGIN
    return y - 7 * HUD_SCALE, y, x, x + len(text) * HUD_ADVANCE


def draw_hud(frame: np.ndarray, text: str) -> None:
    """Write ``text`` (digits, space, ``#.HzKF``) in white into ``frame``
    (H, W, 3) in place, clipped to the frame."""
    r0, r1, c0, _ = hud_box(text)
    for i, c in enumerate(text):
        mask = _GLYPH_MASKS[c]
        x = c0 + i * HUD_ADVANCE
        h = min(mask.shape[0], frame.shape[0] - r0)
        w = min(mask.shape[1], frame.shape[1] - x)
        if h <= 0 or w <= 0:
            break
        frame[r0:r0 + h, x:x + w][mask[:h, :w]] = 255


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class Viewer:
    """Display-loop analogue of the reference VoApp viewer
    (apps/vo_app.cc:42-124): renders the current frame with the disparity
    overlay and a HUD line (frame #, Hz, KF marker).

    With a GUI (``$DISPLAY`` set, cv2 importable and a window opened), keys
    mirror the reference: ``p`` pause, ``q``/ESC quit, ``d`` dump the
    current frame to PNG.  Headless (the normal case on a GPU host) every
    ``dump_every``-th rendered frame is written as a PNG under
    ``dump_dir`` instead, so the same run artifacts exist either way.
    Frames may be numpy arrays or tensors on any device.
    """

    def __init__(self, name: str = "bpvo_tpu_torch", dump_dir: str = None,
                 dump_every: int = 25):
        self._name = name
        self._dump_dir = dump_dir
        self._dump_every = max(1, dump_every)
        self._cv2 = None           # the cv2 module once a window is open
        self._gui = None           # decided on first show()
        self._n = 0

    def _render(self, image, disparity, hz, is_keyframe):
        frame = overlay_disparity(_numpy(image), _numpy(disparity))
        draw_hud(frame, f"#{self._n}  {hz:5.1f} Hz"
                 + ("  KF" if is_keyframe else ""))
        return frame

    def _dump(self, frame):
        if not self._dump_dir:
            return
        os.makedirs(self._dump_dir, exist_ok=True)
        imageio.imwrite(os.path.join(self._dump_dir,
                                     f"frame_{self._n:05d}.png"), frame)

    def _open_window(self) -> bool:
        # cv2.imshow aborts the process (Qt fatal) rather than raising in a
        # truly headless environment, so gate on $DISPLAY first and only
        # then probe the window backend
        if not os.environ.get("DISPLAY"):
            return False
        try:
            import cv2
        except ImportError:
            return False
        try:
            cv2.namedWindow(self._name, cv2.WINDOW_AUTOSIZE)
        except cv2.error:
            return False
        self._cv2 = cv2
        return True

    def show(self, image, disparity, hz: float = 0.0,
             is_keyframe: bool = False) -> bool:
        """Render one frame.  Returns False when the user quit (GUI mode)."""
        frame = self._render(image, disparity, hz, is_keyframe)
        if self._gui is None:
            self._gui = self._open_window()
        if self._gui:
            cv2 = self._cv2
            cv2.imshow(self._name, frame)
            k = cv2.waitKey(1) & 0xFF
            if k in (ord("q"), 27):
                return False
            if k == ord("d"):
                self._dump(frame)
            if k == ord("p"):  # pause until any key (vo_app.cc pause loop)
                while (cv2.waitKey(50) & 0xFF) == 0xFF:
                    pass
        elif self._n % self._dump_every == 0:
            self._dump(frame)
        self._n += 1
        return True

    def close(self):
        if self._gui:
            self._cv2.destroyWindow(self._name)
