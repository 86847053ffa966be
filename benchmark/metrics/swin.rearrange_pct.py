"""``swin.rearrange_pct``: the share of a traced stretch of SwinV2 train
steps' device time in kernels launched under the program's spans
``vst.swin.window`` (the roll, window partition, reverse and roll back,
forward and backward) and ``vst.swin.bias`` (the position-bias table), in
%; lower is better. ``None`` for a program without those spans."""


def read(ctx):
    return ctx.get("rearrange_pct")
