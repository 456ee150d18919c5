"""Device ms a request of the kernels launched inside the port's binning
(``ops/binning.bin_gaussians``, as ``ops/rasterize`` calls it), from the
layer trace."""

SPANS = {"ops/binning": [("street_sparse_3dgs_tpu_torch.ops.rasterize",
                          "bin_gaussians")]}


def read(ctx):
    s = ctx.get("layer_s", {}).get("ops/binning")
    if s is None:
        return None
    return s / ctx["stack_requests"] * 1e3
