"""Device ms a request of the kernels launched inside the port's
projection (``ops/preprocess.project_gaussians``, as ``ops/rasterize``
calls it), from the layer trace: the forward alone, since autograd's
backward opens no span."""

PORT = "street_sparse_3dgs_tpu_torch"
SPANS = {"ops/preprocess": [(PORT + ".ops.rasterize", "project_gaussians")]}


def read(ctx):
    s = ctx.get("layer_s", {}).get("ops/preprocess")
    if s is None:
        return None
    return s / ctx["stack_requests"] * 1e3
