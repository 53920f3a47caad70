"""The numbers that decide ``correct``, each worked out from the
program's readings and the reference's.

Training (the first three steps): the largest relative gap of a step's
loss; and, leaf by leaf, the gap between the program's norm and the
reference's of the first gradient and of the weights' change after the
three steps, measured against the reference's norm of that leaf or of
the median leaf, whichever is larger.  Leaves whose reference gradient
is under a thousandth of the median leaf's, or that have none, are left
out of the change: the first move under Adam by round-off alone; the EMA
codebook has no gradient and moves by dead-code restarts, each a
decision that a rounding can flip (whole rows then differ), so it shows
through the later steps' losses instead.

Serving: the widest gap by which a greedy session's served id's logit
lies below the reference's best logit at that position.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

TINY = 1e-3     # a leaf's gradient under this share of the median's is nought


def _gap(p: float, r: float, scale: float) -> float:
    return abs(p - r) / max(r, scale, 1e-30)


def _leaf_gaps(prog: dict, ref: dict) -> tuple:
    """({leaf: first-gradient gap}, {leaf: change gap}) over the leaves
    each compares."""
    g_ref = ref["grad1"]
    g_med = statistics.median(g_ref.values())
    grad = {k: _gap(prog["grad1"].get(k, 0.0), v, g_med)
            for k, v in g_ref.items()}
    moved = [k for k in ref["change"]
             if k in g_ref and g_ref[k] >= TINY * g_med]
    c_med = statistics.median(ref["change"][k] for k in moved)
    change = {k: _gap(prog["change"].get(k, 0.0), ref["change"][k], c_med)
              for k in moved}
    return grad, change


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` as ``reference/train.py::first_steps``
    returns them."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    grad, change = _leaf_gaps(prog, ref)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}


def leaf_gaps(prog: dict, ref: dict) -> Dict[str, dict]:
    """Every leaf's gaps, for a look at a reading that stands out."""
    grad, change = _leaf_gaps(prog, ref)
    return {"grad": grad, "change": change}


def checks(numbers: Dict[str, Optional[float]], limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every number compared."""
    return {k: {"value": v, "limit": limits.get(k)}
            for k, v in numbers.items()}
