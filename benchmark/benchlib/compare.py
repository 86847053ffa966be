"""The numbers that decide ``correct`` for a train cell.

The program's checked steps and the reference's give, for the same inputs:
each step's loss, the first gradient, and the parameters' (and the EMA's)
change over the checked steps. Each number compared is a gap between the two
sides' readings, relative to the reference:

- ``loss``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad``, ``change``, ``ema``: the worst leaf's ``|norm - ref| /
  max(ref, median ref)`` of the two sides' norms of that leaf, the median
  taken over the leaves compared, since some leaves' readings are all but
  zero; ``grad_median`` and ``change_median``: the median leaf's.

The change and the EMA's change count only the entries that the reference's
first gradient moves: an entry whose gradient is under a thousandth of the
median leaf's root-mean-square gradient is nought to rounding (the key's
bias under the softmax, a third of each attention's ``qkv`` bias), and AdamW
moves it by round-off alone. A leaf with no such entry is left out.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

MOVED_SHARE = 1e-3


def loss_gap(losses, ref_losses) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses, strict=True))


def norms(tensors: Dict, entries: Optional[Dict] = None) -> Dict[str, float]:
    """Each leaf's float64 norm, over ``entries[name]`` where given."""
    out = {}
    for name, t in tensors.items():
        t = t.double()
        if entries is not None:
            if not entries[name].any():
                continue
            t = t[entries[name]]
        out[name] = float(t.norm())
    return out


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap, over the leaves both sides name."""
    if sorted(got) != sorted(ref):
        raise KeyError("the two sides name other leaves")
    median = statistics.median(ref.values())
    return {n: abs(got[n] - ref[n]) / max(ref[n], median) for n in ref}


def leaf_gap(got: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """``(worst gap, its leaf)``."""
    gaps = leaf_gaps(got, ref)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_gap(got: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """``(median leaf's gap, "median leaf")``: steady from seed to seed where
    the worst leaf is one small leaf's rounding."""
    return statistics.median(leaf_gaps(got, ref).values()), "median leaf"


def moved_entries(ref_grads: Dict) -> Dict:
    """The entries of each leaf that the reference's gradient moves."""
    rms = statistics.median(float(g.double().square().mean().sqrt()) for g in ref_grads.values())
    return {n: g.abs() >= MOVED_SHARE * rms for n, g in ref_grads.items()}


def train_numbers(got: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Each compared number with where it was taken: the step or the leaf."""
    moved = moved_entries(ref["grads"])
    grads = norms(got["grads"]), norms(ref["grads"])
    change = norms(got["change"], moved), norms(ref["change"], moved)
    out = {"loss": (loss_gap(got["losses"], ref["losses"]), "worst step"),
           "grad": leaf_gap(*grads),
           "change": leaf_gap(*change), "change_median": median_gap(*change)}
    if ref.get("ema_change") is not None:
        out["ema"] = leaf_gap(norms(got["ema_change"], moved), norms(ref["ema_change"], moved))
    return out


def judge(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    lies within its limit; a number missing or not finite fails (and reads
    ``None``)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, (None, ""))[0]
        good = value is not None and value == value and abs(value) != float("inf")
        checks[name] = {"value": value if good else None, "limit": limit}
        ok = ok and good and value <= limit
    return ok, checks
