"""Faults planted under the timed path, for the tests that must see
``correct`` come out false and for reading a fault's numbers on the card
(``control.py``).  ``plant(name, setattr_)`` patches the port's modules
with ``setattr_`` (``setattr``, or a test's ``monkeypatch.setattr``)
before a run builds its driver."""

from __future__ import annotations


def _state_unchanged(setattr_):
    """The training step returns the state it was given."""
    from street_sparse_3dgs_tpu_torch.train import step

    orig = step.TrainStep.__call__

    def call(self, state, *args, **kwargs):
        _, aux = orig(self, state, *args, **kwargs)
        return state, aux

    setattr_(step.TrainStep, "__call__", call)


def _half_batch(setattr_):
    """The photometric loss leaves out half of the view's pixel rows and
    takes its mean over the rest."""
    from street_sparse_3dgs_tpu_torch.train import losses

    orig = losses.photometric

    def photometric(image, gt, lambda_dssim=0.2):
        h = image.shape[-2] // 2
        return orig(image[..., :h, :], gt[..., :h, :], lambda_dssim)

    setattr_(losses, "photometric", photometric)


def _altered_frame(setattr_):
    """The served image is altered where it is rendered: a sixteenth of
    it brightened by a quarter."""
    from street_sparse_3dgs_tpu_torch.hierarchy import render

    orig = render.render_cut_compact

    def render_cut_compact(*args, **kwargs):
        out = orig(*args, **kwargs)
        img = out["render"]
        h, w = img.shape[-2] // 4, img.shape[-1] // 4
        out["render"] = img.clone()
        out["render"][:, :h, :w] += 0.25
        return out

    setattr_(render, "render_cut_compact", render_cut_compact)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_frame": _altered_frame}


def plant(name: str, setattr_=setattr) -> None:
    FAULTS[name](setattr_)
