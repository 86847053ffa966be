"""``rope_attention_roofline``: the rotary streaming attention's forward and
backward (R1/R2) at an EVA-02 train step's shape, weighted by the calls a
traced step made, as a share of their roofline, in % (see
``benchlib/eva.py``: the operations of the two products forward and five
backward and of the rotations; the bytes of the projection, output,
log-sum-exp, tables and cotangents)."""

from benchlib import eva


def read(ctx):
    calls = ctx.get("rope_attention_calls")
    if not calls or ctx["run"].device != "cuda":
        return None
    return eva.rope_share(calls, ctx["run"].seed)
