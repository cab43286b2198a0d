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


def linear_to_gamma(c):
    """Gamma-2: sqrt of nonnegative components."""
    return torch.sqrt(torch.clamp(c, min=0.0))


def to_bytes(img) -> np.ndarray:
    """(H, W, 3) linear float image (tensor or array) -> (H, W, 3) uint8."""
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.asarray(img, np.float32))
    g = linear_to_gamma(img.to(torch.float32))
    return (256.0 * torch.clamp(g, 0.0, 0.999)).to(torch.uint8).cpu().numpy()


def encode_ppm_p3(b: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> P3 file bytes."""
    h, w, _ = b.shape
    rows = b.reshape(-1, 3).astype(str)
    body = "\n".join(" ".join(r) for r in rows) + "\n"
    return f"P3\n{w} {h}\n255\n".encode() + body.encode()


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
