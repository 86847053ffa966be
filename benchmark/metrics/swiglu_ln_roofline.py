"""``swiglu_ln_roofline``: the SwiGLU sub-LN's forward and backward (G1/G2,
the fold of the norm's gradients included) at an EVA-02 train step's shape,
weighted by the calls a traced step made, as a share of their HBM bound, in
% (see ``benchlib/eva.py``)."""

from benchlib import eva


def read(ctx):
    calls = ctx.get("swiglu_ln_calls")
    if not calls or ctx["run"].device != "cuda":
        return None
    return eva.swiglu_share(calls, ctx["run"].seed)
