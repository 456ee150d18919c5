"""K4's share of its roofline: the least time the exact backward blend
could take for the traced steps' inputs (the larger of its bytes over
HBM bandwidth and its operations over the float32 peak, counted by
``benchmark.reference.counting``) over the device time of its kernels."""

from benchmark.reference import counting

KERNELS = ("blend_exact_bwd_kernel",)


def read(ctx):
    t = sum(s for n, s in ctx.get("kernel_s", {}).items()
            if any(k in n for k in KERNELS))
    if t <= 0 or not ctx.get("counts"):
        return None
    bound = sum(counting.blend_bwd_bound_s(c["passes"], c["visible"],
                                           c["height"], c["width"])
                for c in ctx["counts"])
    return 100.0 * bound / t
