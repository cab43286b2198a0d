"""What decides `correct`: the numbers compared with the plain reference,
each beside its limit, and the look for JAX in the process.

Render and frame cells compare pixels: a pixel is off when a channel
differs from the reference's by more than PIXEL_TOL of the larger of 1 and
the reference's brightest channel; the number is the share of compared
pixels that are off, in %. The training cell compares norms by the worst
leaf: the gap between the program's norm of a leaf and the reference's,
over the larger of the reference's norm of that leaf and of the median
leaf."""
from __future__ import annotations

import math
import statistics

import torch

# the top-level module names that may not be loaded: JAX, its libraries,
# and the JAX package this port was made from (compared as whole names:
# the port's own name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "real_time_ray_tracing_engine_tpu")

PIXEL_TOL = 1e-3


def banned_modules(names) -> list:
    """The loaded modules whose top-level name is one of BANNED."""
    return sorted({n for n in names if n.split(".", 1)[0] in BANNED})


def px_off_share(prog, ref, tol: float = PIXEL_TOL) -> float:
    """% of pixels (rows of (P, 3)) off the reference (module docstring).
    A non-finite value is off."""
    prog = prog.float()
    ref = ref.float()
    scale = torch.clamp(ref.abs().amax(-1), min=1.0)
    off = ((prog - ref).abs().amax(-1) > tol * scale) \
        | ~torch.isfinite(prog).all(-1)
    return 100.0 * float(off.float().mean())


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|; inf where a is not finite."""
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norm_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Per leaf: | |prog| - |ref| | / max(|ref|, the median leaf's |ref|),
    over the leaves in `keep` (all where None); inf for a non-finite
    program norm."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    out = {}
    for k in (keep if keep is not None else ref):
        p = float(prog[k].double().norm())
        denom = max(norms[k], med, 1e-30)
        out[k] = math.inf if not math.isfinite(p) else abs(p - norms[k]) / denom
    return out


def judged(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit
    (a missing or non-finite number is not)."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
