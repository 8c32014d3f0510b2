"""The comparison that decides ``correct``: the numbers compared, each beside
the limit of its cell (``benchmark/limits/<workload>.json``; PERF.md gives
the readings each limit was set from)."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def stream_gaps(port: Dict[str, np.ndarray],
                ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """One sample's decoded boxes (the coder's top ``max_num``, in score
    order) against the reference's: the widest score gap, the widest box
    gap over the reference boxes' largest magnitude, and the share of
    ranks whose label differs."""
    box_scale = max(float(np.abs(ref["bboxes"]).max()), 1e-6)
    return {
        "score_gap": float(np.abs(port["scores"] - ref["scores"]).max()),
        "box_gap": float(np.abs(port["bboxes"] - ref["bboxes"]).max()
                         / box_scale),
        "label_mismatch": float((port["labels"] != ref["labels"]).mean()),
    }


def worst(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


def leaf_gap(prog: np.ndarray, ref: np.ndarray, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    med = float(np.median(ref))
    denom = np.maximum(ref, med)
    return float((np.abs(prog - ref) / denom).max())


def _grad_kept(ref: dict) -> np.ndarray:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others are nought to rounding (a key's bias under
    softmax) and move under AdamW by round-off alone."""
    g_r = np.asarray(ref["grad"], np.float64)
    return g_r >= 1e-3 * float(np.median(g_r))


def _moving(ref: dict) -> np.ndarray:
    return _grad_kept(ref) & (np.asarray(ref["change"], np.float64) > 0)


def median_leaf_gap(prog: np.ndarray, ref: np.ndarray, keep) -> float:
    """The median over the kept leaves of each leaf's gap between the
    program's norm and the reference's, over the larger of the reference's
    norm of that leaf and of the median kept leaf."""
    prog = np.asarray(prog, np.float64)[keep]
    ref = np.asarray(ref, np.float64)[keep]
    return float(np.median(np.abs(prog - ref)
                           / np.maximum(ref, np.median(ref))))


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses`` of steps 1-3, ``grad`` (each leaf's
    gradient norm as AdamW got it at step 1), ``grad_norm`` (step 1's
    global norm before the clip) and ``change`` (each leaf's change after
    three steps), leaves in one order.

    Compared: step 1's loss (steps 2 and 3 carry the sampling backward's
    reduction order, which three AdamW steps amplify: PERF.md gives their
    readings); the worst leaf's gradient and the median leaf's; and the
    median leaf's change, since the worst leaf's change carries steps 2
    and 3, in which the small head leaves' gradients diverge from
    parameters that step 1 left apart by rounding (PERF.md gives the
    element readings). The median leaf's gradient is what catches a
    backward that scales or corrupts gradients, which AdamW's update,
    nearly independent of the gradient's size, hides from the change.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's, and leaves the reference does not move (the frozen stages'
    learning rate is 0), are left out of the medians."""
    return {
        "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "grad_gap": leaf_gap(np.asarray(prog["grad"], np.float64),
                             np.asarray(ref["grad"], np.float64)),
        "grad_median_gap": median_leaf_gap(prog["grad"], ref["grad"],
                                           _grad_kept(ref)),
        "change_gap": median_leaf_gap(prog["change"], ref["change"],
                                      _moving(ref)),
    }


def later_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Readings kept out of the comparison (printed): each later step's
    loss gap, the worst leaf's change, and the gap of step 1's global
    norm before the clip (the clip scales every leaf by max_norm over that
    norm, so its gap enters every leaf's gradient alike: PERF.md)."""
    keep = _moving(ref)
    out = {f"loss{s + 1}_gap": abs(p - r) / abs(r) for s, (p, r) in
           enumerate(zip(prog["losses"], ref["losses"])) if s > 0}
    out["change_worst_leaf_gap"] = leaf_gap(
        np.asarray(prog["change"], np.float64),
        np.asarray(ref["change"], np.float64), keep)
    out["grad_norm_gap"] = abs(prog["grad_norm"] - ref["grad_norm"]) \
        / ref["grad_norm"]
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [[name, value, limit], ...])`` over the numbers the
    cell's limits name: every one finite and at most its limit, and none
    missing. A number the limits do not name is not compared (PERF.md
    gives its readings); :func:`not_compared` lists it."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = ok and math.isfinite(value) and value <= limit
        rows.append([name, value, limit])
    return ok, rows


def not_compared(numbers: Dict[str, float], limits: Dict[str, float]):
    return {k: v for k, v in numbers.items() if k not in limits}
