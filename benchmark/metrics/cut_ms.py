"""Device ms a frame of the hierarchy cut: kernels launched from
``hierarchy/structure`` (the cut and its weights) and ``hierarchy/render``
(compaction, gather and interpolation of the cut's rows)."""

PORT = "street_sparse_3dgs_tpu_torch"
SPANS = {"hierarchy/structure": [(PORT + ".hierarchy.structure",
                                  "select_cut")],
         "hierarchy/render": [(PORT + ".hierarchy.render",
                               "compact_cut_params")]}


def read(ctx):
    layers = ctx.get("layer_s", {})
    parts = [layers[k] for k in SPANS if k in layers]
    if not parts:
        return None
    return sum(parts) / ctx["stack_requests"] * 1e3
