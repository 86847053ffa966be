"""``attention_roofline``: attention's forward and backward at a train
step's stage shapes, as a share of their roofline, in % (see
``benchlib/roofline.py``)."""

from benchlib import roofline


def read(ctx):
    if not ctx.get("attention_calls") or ctx["run"].device != "cuda":
        return None
    return roofline.attention_share(ctx["attention_calls"], ctx["run"].seed, backward=True)
