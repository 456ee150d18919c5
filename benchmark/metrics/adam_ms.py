"""Device ms a step of kernels launched from the optimizer
(``models/adam``: the masked Adam over the rows and the exposure's)."""

PORT = "street_sparse_3dgs_tpu_torch"
SPANS = {"models/adam": [(PORT + ".models.adam", "step"),
                         (PORT + ".models.adam", "dense_step")]}


def read(ctx):
    s = ctx.get("layer_s", {}).get("models/adam")
    if s is None:
        return None
    return s / ctx["stack_requests"] * 1e3
