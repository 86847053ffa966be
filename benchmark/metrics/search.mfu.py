"""``search.mfu``: candidate scoring's share of the card's bf16 peak, in %.

The operations scoring requires: 2 x each scored candidate's own
multiply-adds per image (the frozen copy of the published cost model) x
the sub-val's images, summed over the window's candidates, over the
window's seconds and 989 TFLOP/s. A candidate's own work, not the masked
supernet's full width, so a later change that skips masked work reads
higher without ever reading above the card.
"""

from benchlib import device


def read(ctx):
    if not ctx.get("window_s"):
        return None
    flops = 2.0 * ctx["scored_macs"] * ctx["n_valid"]
    return 100.0 * flops / ctx["window_s"] / device.PEAK_BF16
