"""The work of a 2D Gaussian splatting training step
(`kinds/train_surfels.py`), counted from the reference's own pass
(`reference/surfels.py`'s tally: the slots, the walked and applied pairs,
the rect lanes), never from the program: the operations and bytes of K10
(the blend), K11 (its backward), K12 (the projection) and K13 (its
backward), and the whole step's FP32 operations.

Per walked pair, the ray-splat test: h_v (6), the cross product (9), the
filter's distance (6), the comparison (5), the intersection (9: two
quotients, u^2 + v^2, the depth), alpha and the transmittance test (7),
and h_u's share (3): 45. Per applied pair, K10's sums: the weight, the
distortion's depth and its three running sums (15), the colour, normal and
depth sums (14): 29; K11's: dL/dw (20), the suffix identity (8), the
opacity, rho and depth terms (14), the chain through the quotients and the
cross product into T or the centre (40), the colour and normal (12) and the
18 pixel sums (18): 112. Per surfel, K12: the view transform (18), the
rotation (30), the scaled axes and the normal (33), T and the centre (17),
the flip and the opacity (9), the binning proxy (60: the dual conic, the
ellipse, the rect) and the SH colour (`roofline.SH_OPS`); K13 about twice
the forward (`roofline.BACKWARD_FACTOR`). Bytes: each input read once and
each output written once: the blend's table rows and ids by slot, its
twelve floats a pixel out (colour, T, normal, depth sum, distortion, the
three final sums), K11's nine gradient floats a pixel and those twelve in
and its 18 slot gradients out; the projection's 232 bytes a surfel in and
121 out at SH degree 3, its backward's 304 in and 232 out.

The step adds to these the cull over the rect lanes, the gather
backward's sum of 18 rows a slot (K4), the regularisers (the depth map's
normals, the normal and distortion losses and their backward, about 150
operations a pixel), L1 + DSSIM and Adam over the five fields.
"""

from __future__ import annotations

from splatbench import roofline as RF

OPS_PER_WALKED = 45
K10_OPS_PER_APPLIED = 29
K11_OPS_PER_APPLIED = 112
PROJECT_OPS = 167
TABLE_COLS = 18
MAP_FLOATS = 12
GRAD_FLOATS = 9
REG_OPS_PER_PIXEL = 150
# The kernels' names in a trace (csrc/surfel_fwd.cu, surfel_bwd.cu,
# surfel_project.cu).
KERNEL_NAMES = {"K10": "splat2d_blend_fwd", "K11": "splat2d_blend_bwd",
                "K12": "splat2d_project_fwd", "K13": "splat2d_project_bwd"}


def _pixels(rc: dict) -> int:
    return rc["width"] * rc["height"]


def _sh_bytes(sh_coeffs: int) -> int:
    return 4 * 3 * sh_coeffs


def work(tally: dict, rc: dict, n: int, sh_coeffs: int) -> dict:
    """{"K10": (ops, bytes), ... "K13": ...} of one view."""
    walked, applied, slots = tally["walked"], tally["applied"], \
        tally["slots"]
    tiles = RF._tiles(rc) + 1
    px = _pixels(rc)
    proj_in = 4 * (3 + 2 + 4 + 1) + _sh_bytes(sh_coeffs)
    proj_out = 4 * (9 + 2 + 3 + 1 + 3 + 2 + 3 + 1 + 1 + 4 + 1) + 1
    return {
        "K10": (OPS_PER_WALKED * walked + K10_OPS_PER_APPLIED * applied,
                4 * (slots * (TABLE_COLS + 1) + tiles + MAP_FLOATS * px)),
        "K11": (OPS_PER_WALKED * walked + K11_OPS_PER_APPLIED * applied,
                4 * (slots * (2 * TABLE_COLS + 1) + tiles
                     + (MAP_FLOATS + GRAD_FLOATS) * px)),
        "K12": (n * (PROJECT_OPS + RF.SH_OPS), n * (proj_in + proj_out)),
        "K13": (RF.BACKWARD_FACTOR * n * (PROJECT_OPS + RF.SH_OPS),
                n * (2 * proj_in + 4 * (9 + 2 + 3 + 1 + 3))),
    }


def step_ops(tally: dict, rc: dict, n: int, params_per_surfel: int,
             ssim_weight: float, sh_coeffs: int) -> float:
    """FP32 operations of one 2D Gaussian splatting training step on one
    view."""
    w = work(tally, rc, n, sh_coeffs)
    pixels = _pixels(rc)
    loss = pixels * 3 * (RF.L1_OPS + (RF.SSIM_OPS if ssim_weight else 0))
    return (sum(w[k][0] for k in w)
            + RF.K3_OPS_PER_LANE * tally["rect_lanes"]
            + RF.K3_OPS_PER_SPLAT * n
            + TABLE_COLS * tally["slots"]
            + REG_OPS_PER_PIXEL * pixels + loss
            + RF.ADAM_OPS * n * params_per_surfel)


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Device seconds per call of the kernel named in KERNEL_NAMES, by its
    name: per name, the mean record times the eager launches per call,
    else the records' sum over the calls."""
    sub = KERNEL_NAMES[kernel]
    total = 0.0
    for name, k in trace["kernels"].items():
        if sub not in name:
            continue
        if name in trace["eager"]:
            total += k["sum_s"] / k["n"] * trace["eager"][name]
        else:
            total += k["sum_s"] / trace["calls"]
    return total


def roofline_pct(trace: dict, kernel: str):
    """The kernel's share of its roofline; None where the window ran none
    or the cell counts no such work."""
    work_ = trace.get("work", {}).get(kernel)
    t = kernel_seconds(trace, kernel)
    if work_ is None or t <= 0.0:
        return None
    return 100.0 * RF.bound_s(*work_) / t
