"""PyTorch/CUDA port of ``street_sparse_3dgs_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module layout and its ``NamedTuple`` interfaces so that a test can feed the
same numpy inputs to both and compare what comes out.  The first slice
covers the forward LOD render path:

    hierarchy.structure.select_cut -> hierarchy.render.render_cut_compact
        -> ops.rasterize.rasterize(method="pallas")

where ``method="pallas"`` selects the hand-written CUDA kernels in
``csrc/`` (built at first use by ``native``).  Entry points that create
tensors default to ``device="cuda"`` and raise when no card is present,
unless the caller passes ``device="cpu"``; functions that take tensors run
on the device of those tensors.
"""
