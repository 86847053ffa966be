"""``window_attention_roofline``: the windowed cosine attention's forward
and backward (the bias gradient's fold included) at a SwinV2 train step's
stage shapes, weighted by calls a step, as a share of their roofline, in %
(see ``benchlib/swin.py``: the operations of the two products forward and
five backward, the bytes of the projection, output, cotangents, the bias
read and its gradient written)."""

from benchlib import swin


def read(ctx):
    calls = ctx.get("window_calls")
    if not calls or ctx["run"].device != "cuda":
        return None
    run = ctx["run"]
    head_dim = run.config["embed_dim"] // run.config["num_heads"][0]
    return swin.window_share(calls, run.seed, head_dim, run.mix["flags"]["batch_size"])
