"""Share of the traced window in which no operation ran on the device,
from the union of the device's events."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
