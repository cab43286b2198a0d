"""Color conversion and PPM I/O.

Byte-comparable with the reference's output path and with the JAX
package's utils/color.py: gamma-2 (sqrt) conversion
(src/utils/ColorUtility.hpp:11-16), clamp to [0, 0.999] and scale by 256
(:19-26), P3 ASCII PPM with one "r g b" triple per line (:30-37, header
src/core/camera/StaticCamera.cpp:57). The P3 body is formatted by the C++
encoder (csrc/ppm_io.cpp, the JAX package's native/ppm_io.cpp) where a C++
compiler built it, else by its plain version, the vectorised numpy
encoder: the same bytes either way.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .native import BUILD, CSRC, shared_library
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


def _header(b: np.ndarray) -> bytes:
    h, w, _ = b.shape
    return f"P3\n{w} {h}\n255\n".encode()


def encode_ppm_p3_numpy(b: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> P3 file bytes: "r g b" per pixel, one pixel a
    line. Vectorised: every value's digits and its separator (a space, or a
    newline after blue) are scattered into one byte buffer at the offsets
    of a cumulative sum of their lengths."""
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
    return _header(b) + body.tobytes()


def _encoder():
    """rtx_encode_ppm_p3 of csrc/ppm_io.cpp, compiled at first use into
    build/ppm/ (utils/native.py); None where no C++ compiler exists or the
    build fails."""
    path = shared_library(CSRC / "ppm_io.cpp", BUILD / "ppm", "libppm.so")
    if path is None:
        return None
    fn = ctypes.CDLL(str(path)).rtx_encode_ppm_p3
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    fn.restype = ctypes.c_int64
    fn.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64]
    return fn


def encode_ppm_p3_native(b: np.ndarray) -> bytes | None:
    """encode_ppm_p3_numpy's bytes by the C++ encoder; None where it is not
    available."""
    fn = _encoder()
    if fn is None:
        return None
    px = np.ascontiguousarray(b, np.uint8).reshape(-1, 3)
    out = np.empty(px.shape[0] * 12, np.uint8)
    n = fn(px, px.shape[0], out, out.size)
    if n < 0:
        raise RuntimeError(f"the C++ PPM encoder's buffer of {out.size} "
                           f"bytes is too small")
    return _header(b) + out[:n].tobytes()


_announced = set()


def encode_ppm_p3(b: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> P3 file bytes: the C++ encoder where it builds,
    else the numpy encoder (printed once a process)."""
    body = encode_ppm_p3_native(b)
    if body is not None:
        return body
    if "numpy" not in _announced:
        _announced.add("numpy")
        print("[INFO] PPM encoder: numpy (no C++ compiler built "
              "csrc/ppm_io.cpp)", file=sys.stderr, flush=True)
    return encode_ppm_p3_numpy(b)


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
