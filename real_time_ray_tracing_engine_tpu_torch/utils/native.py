"""The port's host C++ libraries: csrc/bvh_builder.cpp (ops/bvh.py) and
csrc/ppm_io.cpp (utils/color.py), each compiled with g++ at first use and
bound with ctypes by its caller.

A library is built into build/<name>/<hash>/ (git-ignored), the hash
covering the source and the flags, so an edited source builds anew. The
flags are the JAX package's (native/__init__.py), -march=native among
them: a library is only good on the host that built it. Where no C++
compiler exists, or the build fails, the callers take their numpy
versions.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
# the BVH builder's float32 SAH sums depend on them: other flags contract
# a*b+c differently and give another tree
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def shared_library(source: Path, build_dir: Path, name: str) -> Path | None:
    """The path of `source` compiled into build_dir/<hash>/<name>, built
    here if it is not there yet; None where no C++ compiler exists or the
    build fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    path = build_dir / h.hexdigest()[:16] / name
    if path.exists():
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    # build to a temporary file and rename: parallel builders race here
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, str(source)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return path
