"""``device.idle_pct.train``: the share of a profiled stretch of train
steps in which no operation runs on the card, in %, from the
``torch.profiler`` device timeline (``benchlib.device.reduce_trace``)."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
