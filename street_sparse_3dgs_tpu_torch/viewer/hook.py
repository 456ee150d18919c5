"""Glue between the training loop and the live SIBR viewer, mirroring
``street_sparse_3dgs_tpu/viewer/hook.py``.

The reference polls ``network_gui`` at the top of every training iteration
and renders the requester's camera with the *current* model state
(``train_single.py:80-97``).  :class:`ViewerHook` packages that: construct
it with a listening :class:`~.network_gui.NetworkGUI` and pass it to
``train_loop`` as ``LoopHooks.viewer_poll``.  The frame is rendered under
``torch.no_grad()`` through ``rasterize`` with ``raster_config(pipe)`` (so
``raster_method="pallas"`` renders with the CUDA kernels) on the state's
device, and handed to the socket on the host.  ``req.keep_alive`` selects
RGB vs inverse-depth frames exactly like the reference
(``train_single.py:88-92``).
"""

from __future__ import annotations

import torch

from ..models.gaussians import activate_opacity, activate_scales, sh_coeffs
from ..ops.rasterize import rasterize


def render_view(params, active, camera, meta, bg, scale_modifier: float,
                cfg, depth_mode: bool) -> torch.Tensor:
    """[3, H, W] frame in [0, 1]: the render, or the inverse depth
    broadcast to three channels."""
    with torch.no_grad():
        out = rasterize(params.xyz, activate_scales(params), params.quats,
                        activate_opacity(params, meta), sh_coeffs(params),
                        camera, meta.sh_degree, bg, cfg,
                        scale_modifier=scale_modifier, active_mask=active)
        if depth_mode:
            img = out["depth"].expand((3,) + tuple(out["depth"].shape[1:]))
        else:
            img = out["render"]
        return torch.clamp(img, 0.0, 1.0)


class ViewerHook:
    """``LoopHooks.viewer_poll`` implementation.

    Parameters: ``gui`` (a listening NetworkGUI), ``source_path`` (the
    verify string echoed to the viewer — the dataset path on the
    reference), ``pipe`` (PipelineConfig for the raster knobs).
    """

    def __init__(self, gui, source_path: str, pipe):
        from ..train.step import raster_config

        self.gui = gui
        self.source_path = source_path
        self.cfg = raster_config(pipe)

    def __call__(self, state, meta, training_done: bool = False,
                 bg=None) -> bool:
        dev = state.params.xyz.device
        if bg is None:
            bg = torch.zeros(3, dtype=torch.float32, device=dev)

        def render_fn(req):
            img = render_view(state.params, state.active,
                              req.camera(device=dev), meta, bg,
                              float(req.scaling_modifier), self.cfg,
                              not req.keep_alive)
            return img.cpu().numpy()

        return self.gui.poll(render_fn, self.source_path, training_done)

    def close(self) -> None:
        self.gui.close()
