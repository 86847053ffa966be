"""``masked_ln_roofline``: the masked layer norm's forward and backward at a
supernet train step's stage widths, as a share of their roofline, in % (see
``benchlib/roofline.py``). Example ``b`` takes architecture ``b % A``, as
the step's masks are laid out."""

from benchlib import roofline


def read(ctx):
    calls = ctx.get("masked_ln_calls")
    if not calls or ctx["run"].device != "cuda":
        return None
    archs = calls[0][0][0] // ctx["example_per_arch"]
    return roofline.masked_ln_share(calls, ctx["run"].seed, lambda b: b % archs, backward=True)
