"""The numbers that decide `correct`, and their limits.

Each workload's limits are a file of their own, `splatbench/limits/
<workload>.json`: {"<number>": {"limit": x, "lower": ..., "upper": ...,
"readings": ...}} (read by `run.load_limits`), set between the readings
of the program and of the control that `PERF.md` gives. A number is
within its limit when it is at most the limit; NaN never is.
"""

from __future__ import annotations

import math
import statistics

import torch


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number without a limit, or a limit without its number, is a fault."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} against limits "
                         f"{sorted(limits)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks


def image_numbers(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """The root mean square and the largest absolute difference of two
    (H, W, 3) images."""
    d = program.float() - reference.float()
    return {"frame_rmse": float(torch.sqrt(torch.mean(d * d))),
            "frame_max_abs": float(d.abs().max())}


def norm_gaps(program: dict, reference: dict, own: bool = False) -> list:
    """Each field's gap between the program's norm and the reference's,
    over the reference's norm of that field or of the median field,
    whichever is larger (of that field alone where `own`)."""
    med = statistics.median(reference.values())
    return [abs(program[k] - r) / (r if own else max(r, med))
            for k, r in reference.items()]


def _of(gaps: list, pick) -> float:
    return float("nan") if any(map(math.isnan, gaps)) else pick(gaps)


def train_numbers(program: dict, reference: dict) -> dict:
    """The training step's numbers, over the set-up steps (the first
    runs eagerly as the captured step's warm-up, the later ones are its
    replays): the first step's loss gap and the worst of the later steps'
    (each over the reference's loss); the median and the worst field's
    gap of first-gradient norms; the worst field's gap of change norms
    over the steps, each over that field's own change.

    The later losses read more than the first: Adam's first updates move
    each element by about its rate times the sign of its gradient, and
    where a gradient is all but zero rounding sets the sign, so from step
    2 on the two sides' parameters part by rounding. The median field's
    gradient is the steady reading; the worst field's swings from seed to
    seed (one or two jumbo splats can carry a field's whole gap, their
    bf16-pair sums off by a bf16 step, which the configuration states)."""
    loss = [abs(p - r) / abs(r)
            for p, r in zip(program["losses"], reference["losses"])]
    grad = norm_gaps(program["grad_norms"], reference["grad_norms"])
    return {
        "first_loss_gap": loss[0],
        "later_loss_gap": _of(loss[1:], max),
        "grad_median_gap": _of(grad, statistics.median),
        "grad_worst_gap": _of(grad, max),
        "change_gap": _of(norm_gaps(program["change_norms"],
                                    reference["change_norms"], own=True), max),
    }
