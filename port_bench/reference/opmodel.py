"""The roofline's operation count: a frozen copy of the op model of the
port's utils/profiling.py (OPS_*, light_ops, vscan_bounce_ops,
adjoint_bounce_ops), and the table of peaks.

Operations of one bounce of a kernel lane on a Lambertian hit, counted by
hand from the kernels' source: each add, multiply, divide, compare,
min/max, sqrt and transcendental is one, and the RNG's 32-bit integer
operations count at the same rate. Every scene's intersection is counted
as what the inputs need at least, a binary BVH descent (2 ceil(log2 N) box
tests of OPS_BOX and 2 primitive tests), whatever the kernel does: so the
bound reads the same work whichever kernel implements it. Bytes are left
out: the tables are under 1 MB and a lane's state a few floats, so the
bound is the operations' time.
"""
from __future__ import annotations

import math

# float32 operations/s outside the tensor cores, FMA counted as two, by a
# prefix of torch.cuda.get_device_name(): NVIDIA's data sheet of the H100
# SXM at its 700 W power limit
PEAK_FP32 = {"NVIDIA H100 80GB HBM3": 67e12}

OPS_RNG = 126             # 9 draws: 3 PCG4D blocks of 32 ops, +10 each
OPS_HIT = 17              # dot(d, d), the hit point and normal
OPS_SPHERE = 37           # moving center, roots, nearest-root selection
OPS_QUAD = 59             # plane t, the inside test, range compares
OPS_SHADE = 91            # ONB (40), cosine sample (35), pdfs and MIS
                          # weight (10), throughput update (6)
OPS_LIGHT_PDF = {"sphere": 55, "quad": 62}       # per light, every bounce
OPS_LIGHT_SAMPLE = {"sphere": 100, "quad": 25}   # one light, half the time
OPS_BOX = 30              # a box test, about 10 operations an axis
# the adjoint's parameter rows: tex_color 3, the winner sphere's 4, a fuzz
# or IOR, with their routing
OPS_ADJ_ROWS = 16


def peak_flops(device_name: str) -> float | None:
    """The float32 peak of a card by its name, None for a card not in the
    table (a roofline share is then not reported)."""
    for prefix, peak in PEAK_FP32.items():
        if device_name.startswith(prefix):
            return peak
    return None


def light_ops(flat) -> float:
    """Every light's pdf, and half the bounces one light's sample."""
    kinds = ["sphere" if bool(x) else "quad" for x in
             (flat.light_prim[:flat.n_lights]
              < flat.sph_center.shape[0]).tolist()]
    if not kinds:
        return 0.0
    return (sum(OPS_LIGHT_PDF[k] for k in kinds)
            + 0.5 * sum(OPS_LIGHT_SAMPLE[k] for k in kinds) / len(kinds))


def forward_bounce_ops(flat) -> float:
    """Operations of one forward bounce, its intersection counted as a
    BVH descent (the port's vscan_bounce_ops): a lower bound."""
    n_sph = int(flat.sph_active.sum())
    n = n_sph + int(flat.quad_active.sum())
    prim = OPS_SPHERE if n_sph else OPS_QUAD
    return float(OPS_RNG + OPS_HIT + OPS_SHADE + light_ops(flat)
                 + 2 * math.ceil(math.log2(max(n, 2))) * OPS_BOX + 2 * prim)


def adjoint_bounce_ops(flat) -> float:
    """Operations of one bounce of the adjoint: its forward phase
    (forward_bounce_ops) and its reverse phase, which draws the bounce's
    numbers again and pushes the cotangents back through the winner's
    root, the hit record, the shading and the lights at two operations for
    each forward one, and adds the parameter rows' cotangents."""
    shade = OPS_HIT + OPS_SHADE + light_ops(flat) + OPS_SPHERE
    return forward_bounce_ops(flat) + OPS_RNG + 2 * shade + OPS_ADJ_ROWS
