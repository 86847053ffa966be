"""``masked_ln_fwd_roofline``: the masked layer norm's forward at a scoring
forward's stage widths, as a share of its roofline, in % (see
``benchlib/roofline.py``). Each candidate of a chunk holds its own run of
rows, as scoring tiles them."""

from benchlib import roofline


def read(ctx):
    calls = ctx.get("masked_ln_calls")
    if not calls or ctx["run"].device != "cuda":
        return None
    rows = ctx["rows_per_candidate"]
    return roofline.masked_ln_share(calls, ctx["run"].seed, lambda b: b // rows,
                                    backward=False)
