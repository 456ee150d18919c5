"""PyTorch/CUDA port of ``street_sparse_3dgs_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module layout and its ``NamedTuple`` interfaces so that a test can feed the
same numpy inputs to both and compare what comes out.  It covers the
system from its command line down to the kernels:

    cli (train-coarse, train-single, train-post, render-hierarchy,
         full-train) -> pipeline.full_train (coarse scaffold, per chunk
         train / hierarchy build / post-optimization, merge)
        -> train.loop / train.post / eval.render_hier / viewer.hook
        -> ops.rasterize.rasterize(method="pallas")

where ``method="pallas"`` (``--raster_method pallas``) selects the
hand-written CUDA kernels in ``csrc/`` (built at first use by ``native``).
Entry points that create tensors default to ``device="cuda"`` (the CLI's
``--device cuda``) and raise when no card is present, unless the caller
asks for the CPU; functions that take tensors run on the device of those
tensors.
"""
