"""Color conversion and PPM I/O.

Byte-comparable with the reference's output path and with the JAX
package's utils/color.py: gamma-2 (sqrt) conversion
(src/utils/ColorUtility.hpp:11-16), clamp to [0, 0.999] and scale by 256
(:19-26), P3 ASCII PPM with one "r g b" triple per line (:30-37, header
src/core/camera/StaticCamera.cpp:57). The encoder is numpy; the JAX
package's optional C++ encoder (native/ppm_io.cpp) writes the same bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from .vecmath import sqrt


def linear_to_gamma(c):
    """Gamma-2: sqrt of nonnegative components."""
    return sqrt(torch.clamp(c, min=0.0))


def to_bytes(img) -> np.ndarray:
    """(H, W, 3) linear float image (tensor or array) -> (H, W, 3) uint8."""
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.asarray(img, np.float32))
    g = linear_to_gamma(img.to(torch.float32))
    return (256.0 * torch.clamp(g, 0.0, 0.999)).to(torch.uint8).cpu().numpy()


# the decimal digits of each byte value, left-aligned in 3 columns, and
# their count
_DIGITS = np.zeros((256, 3), np.uint8)
_N_DIGITS = np.zeros(256, np.int64)
for _v in range(256):
    _d = str(_v).encode()
    _DIGITS[_v, :len(_d)] = np.frombuffer(_d, np.uint8)
    _N_DIGITS[_v] = len(_d)


def encode_ppm_p3(b: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> P3 file bytes: "r g b" per pixel, one pixel a
    line. Vectorised: every value's digits and its separator (a space, or a
    newline after blue) are scattered into one byte buffer at the offsets
    of a cumulative sum of their lengths."""
    h, w, _ = b.shape
    vals = np.ascontiguousarray(b, np.uint8).reshape(-1)
    n_dig = _N_DIGITS[vals]
    start = np.cumsum(n_dig + 1) - (n_dig + 1)
    body = np.empty(int(n_dig.sum()) + vals.size, np.uint8)
    for k in range(3):
        has = n_dig > k
        body[start[has] + k] = _DIGITS[vals[has], k]
    sep = np.full(vals.size, ord(" "), np.uint8)
    sep[2::3] = ord("\n")
    body[start + n_dig] = sep
    return f"P3\n{w} {h}\n255\n".encode() + body.tobytes()


def write_ppm(path, img):
    """Write a linear float (H, W, 3) image as P3 ASCII PPM."""
    with open(path, "wb") as f:
        f.write(encode_ppm_p3(to_bytes(img)))


def read_ppm(path) -> np.ndarray:
    """Read a P3 ASCII PPM into a uint8 (H, W, 3) array."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path}: only P3 ASCII PPM is supported")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxv != 255:
        raise ValueError(f"{path}: max value {maxv}, expected 255")
    data = np.array(tokens[4:4 + w * h * 3], dtype=np.int64)
    return data.reshape(h, w, 3).astype(np.uint8)
