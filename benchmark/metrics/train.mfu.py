"""``train.mfu``: the train step's share of the card's bf16 peak, in %.

The operations the step requires, 3 x 2 x the network's multiply-adds per
image at the cell's resolution (the frozen copy of the published cost
model; a supernet counts its full width, which the masked step computes),
times the window's images per second, over 989 TFLOP/s.
"""

from benchlib import device


def read(ctx):
    rate = ctx.get("imgs_per_s")
    if not rate:
        return None
    return 100.0 * rate * 6.0 * ctx["macs_per_image"] / device.PEAK_BF16
