"""``attention_fwd_roofline``: attention's forward at a scoring forward's
stage shapes (a chunk's candidates tiled over a sub-val batch), as a share
of its roofline, in % (see ``benchlib/roofline.py``)."""

from benchlib import roofline


def read(ctx):
    if not ctx.get("attention_calls") or ctx["run"].device != "cuda":
        return None
    return roofline.attention_share(ctx["attention_calls"], ctx["run"].seed, backward=False)
