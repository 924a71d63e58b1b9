"""The Canny control signal's OpenCV steps without OpenCV, bit for bit.

The JAX package makes IC-LoRA's Canny control video with three OpenCV calls
per frame (ltx2_tpu/pipelines/ic_lora.py `preprocess_canny`):
`cv2.resize(frame, (w, h), interpolation=cv2.INTER_LANCZOS4)`,
`cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)` and `cv2.Canny(gray, low, high)`
(aperture 3, the L1 gradient). Each function here gives the same uint8
result as OpenCV's generic code (its IPP and SIMD paths give the same):

- `resize_lanczos4`: per output pixel, cvFloor of the source coordinate
  (d + 0.5) x scale - 0.5 in float32 and the eight Lanczos weights of
  `interpolateLanczos4` (float32, normalized to sum 1; a fraction under
  FLT_EPSILON takes the identity), each cast to a short at 2048
  (INTER_RESIZE_COEF_SCALE, rounded half to even); a horizontal pass into
  int32 sums and a vertical one, rounded at 22 bits and saturated, the
  source indices clamped at the edges;
- `bgr_to_gray`: the fixed-point RGB2Gray<uchar> (15-bit coefficients
  9798, 19235, 3735 for R, G, B and half a unit);
- `canny`: 3x3 Sobel derivatives in int16 with replicated borders, the L1
  magnitude with a zero border around the image, non-maximum suppression
  by the TG22 fixed-point sector test (CANNY_SHIFT 15; `>` against the
  previous neighbour and `>=` against the next one, `>` both ways on the
  diagonals), thresholds cvFloor'd, pixels above `high` strong, those
  above `low` candidates, and the candidates 8-connected to a strong pixel
  kept (`scipy.ndimage.label`; OpenCV walks a stack over its map, whose
  one-pixel frame outside the image is never an edge).
"""

from __future__ import annotations

import math

import numpy as np

INTER_RESIZE_COEF_BITS = 11
INTER_RESIZE_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS
CANNY_SHIFT = 15
TG22 = int(0.4142135623730950488016887242097 * (1 << CANNY_SHIFT) + 0.5)
FLT_EPSILON = np.float32(1.1920929e-07)


def _lanczos4_weights(fx: np.ndarray) -> np.ndarray:
    """interpolateLanczos4 for each float32 fraction -> (n, 8) float32."""
    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45], [-1, 0], [s45, s45], [0, -1], [-s45, s45]])
    fx = fx.astype(np.float32)
    y0 = -(fx + np.float32(3)).astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.empty((fx.size, 8), np.float32)
    total = np.zeros(fx.size, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # a zero fraction: replaced by the identity below
        for i in range(8):
            y = -(fx + np.float32(3) - np.float32(i)).astype(np.float64) * math.pi * 0.25
            coeffs[:, i] = ((cs[i, 0] * s0 + cs[i, 1] * c0) / (y * y)).astype(np.float32)
            total = (total + coeffs[:, i]).astype(np.float32)
        coeffs *= (np.float32(1) / total)[:, None]
    identity = fx < FLT_EPSILON
    coeffs[identity] = 0
    coeffs[identity, 3] = 1
    return coeffs


def _axis_taps(src_size: int, dst_size: int):
    """The eight clamped source indices and fixed-point weights of each
    output position along one axis."""
    scale = 1.0 / (float(dst_size) / src_size)
    fx = ((np.arange(dst_size) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    weights = np.rint(_lanczos4_weights(fx) * np.float32(INTER_RESIZE_COEF_SCALE)).astype(np.int64)
    weights = np.clip(weights, -32768, 32767)
    index = np.clip(sx[:, None] - 3 + np.arange(8)[None], 0, src_size - 1)
    return index, weights


def resize_lanczos4(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> (height, width[, C]) as
    `cv2.resize(img, (width, height), interpolation=cv2.INTER_LANCZOS4)`."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    xi, xw = _axis_taps(w, width)
    yi, yw = _axis_taps(h, height)
    src = img.astype(np.int64)
    extra = (None,) * (img.ndim - 2)
    rows = np.zeros((h, width) + img.shape[2:], np.int64)
    for k in range(8):
        rows += src[:, xi[:, k]] * xw[(None, slice(None), k) + extra]
    out = np.zeros((height, width) + img.shape[2:], np.int64)
    for k in range(8):
        out += rows[yi[:, k]] * yw[(slice(None), k, None) + extra]
    return np.clip((out + (1 << (2 * INTER_RESIZE_COEF_BITS - 1))) >> (2 * INTER_RESIZE_COEF_BITS), 0,
                   255).astype(np.uint8)


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) BGR -> (H, W) as `cv2.cvtColor(img,
    cv2.COLOR_BGR2GRAY)`."""
    b, g, r = (np.asarray(img)[..., c].astype(np.int32) for c in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def _sobel3(gray: np.ndarray):
    """The 3x3 Sobel dx and dy of an 8-bit image, replicated borders."""
    p = np.pad(gray.astype(np.int32), 1, mode="edge")
    smooth_y = p[:-2] + 2 * p[1:-1] + p[2:]  # [1 2 1] down the columns
    smooth_x = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]  # [1 2 1] along the rows
    dx = smooth_y[:, 2:] - smooth_y[:, :-2]
    dy = smooth_x[2:] - smooth_x[:-2]
    return dx, dy


def canny(gray: np.ndarray, low_threshold: float, high_threshold: float) -> np.ndarray:
    """uint8 (H, W) -> (H, W) edges (0 or 255) as `cv2.Canny(gray, low,
    high)` (aperture 3, L2gradient off)."""
    from scipy import ndimage

    gray = np.asarray(gray, np.uint8)
    if low_threshold > high_threshold:
        low_threshold, high_threshold = high_threshold, low_threshold
    low, high = math.floor(low_threshold), math.floor(high_threshold)
    h, w = gray.shape
    dx, dy = _sobel3(gray)
    mag = np.zeros((h + 2, w + 2), np.int64)
    mag[1:-1, 1:-1] = np.abs(dx) + np.abs(dy)
    m = mag[1:-1, 1:-1]
    left, right = mag[1:-1, :-2], mag[1:-1, 2:]
    up, down = mag[:-2, 1:-1], mag[2:, 1:-1]
    up_left, up_right = mag[:-2, :-2], mag[:-2, 2:]
    down_left, down_right = mag[2:, :-2], mag[2:, 2:]
    x = np.abs(dx).astype(np.int64)
    y = np.abs(dy).astype(np.int64) << CANNY_SHIFT
    tg22x = x * TG22
    tg67x = tg22x + (x << (CANNY_SHIFT + 1))
    horizontal = y < tg22x
    vertical = ~horizontal & (y > tg67x)
    same_sign = (dx ^ dy) >= 0  # s = 1: up-left against down-right
    diag_prev = np.where(same_sign, up_left, up_right)
    diag_next = np.where(same_sign, down_right, down_left)
    peak = np.where(horizontal, (m > left) & (m >= right),
                    np.where(vertical, (m > up) & (m >= down), (m > diag_prev) & (m > diag_next)))
    candidate = peak & (m > low)
    strong = candidate & (m > high)
    labels, count = ndimage.label(candidate, structure=np.ones((3, 3), bool))
    keep = np.zeros(count + 1, bool)
    keep[np.unique(labels[strong])] = True
    keep[0] = False
    return np.where(keep[labels], 255, 0).astype(np.uint8)
