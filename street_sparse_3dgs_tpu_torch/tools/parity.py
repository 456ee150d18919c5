"""Image and grad parity of the rasterizer's paths on one toy view, the
port's counterpart of ``tools/tpu_parity.py``.

A 1,024-row toy scene at 128x96 (bg 0.3, 0.5, 0.7) renders through four
configs and takes the grads of mean(render^2) + 0.05 mean(depth) with
respect to the means and scales:

- oracle (dense, O(pixels x N));
- tiled (``max_dup`` 64, K 512: the plain PyTorch blend);
- kernels padded (the same knobs: K5, K1, K2);
- kernels exact (``max_dup`` 2, overscan 16, tails ((2048, 6), (512, 24),
  (128, 96)), K 128, ``exact_extra`` 128, the counts backward: K5, K3,
  K4).

Pass (the JAX tool's bar): each kernel config's image within 6e-3 of the
oracle's (boundary flips only), and its grads' max difference from the
oracle's within 2x the tiled path's.  ``--bench`` then runs
``tools/bench``::

    python -m street_sparse_3dgs_tpu_torch.tools.parity [--device cpu]
        [--bench]

``main`` returns {"images", "grads", "diffs", "passed"}; the diffs keep the
JAX tool's names.
"""

from __future__ import annotations

import argparse

import torch

from ..data.toy import make_toy_scene
from ..device import resolve_device
from ..ops.rasterize import RasterConfig, rasterize

IMAGE_BAR = 6e-3
GRAD_FACTOR = 2.0
CONFIGS = {
    "oracle": RasterConfig(method="oracle"),
    "tiled": RasterConfig(method="tiled", max_dup=64, tile_capacity=512),
    "pallas": RasterConfig(method="pallas", max_dup=64, tile_capacity=512),
    "exact": RasterConfig(method="pallas", max_dup=2, dup_overscan=16,
                          dup_tails=((2048, 6), (512, 24), (128, 96)),
                          tile_capacity=128, exact_extra=128,
                          grad_reduce="counts"),
}


def run(scene, cfg: RasterConfig, bg: torch.Tensor):
    """(image [3, H, W], [d means, d scales]) of the parity loss."""
    means = scene.means3d.detach().requires_grad_()
    scales = scene.scales.detach().requires_grad_()
    out = rasterize(means, scales, scene.quats, scene.opacities,
                    scene.sh_coeffs, scene.cameras[0], 3, bg, cfg)
    loss = torch.mean(out["render"] ** 2) + 0.05 * torch.mean(out["depth"])
    grads = torch.autograd.grad(loss, [means, scales])
    return out["render"].detach(), [g.detach() for g in grads]


def parity(scene, bg: torch.Tensor) -> dict:
    """Every config's image and grads, the JAX tool's diffs and the bar."""
    imgs, grads = {}, {}
    for name, cfg in CONFIGS.items():
        imgs[name], grads[name] = run(scene, cfg, bg)

    def mx(a, b):
        return float((a - b).abs().max())

    diffs = {"img tiled-oracle": mx(imgs["tiled"], imgs["oracle"]),
             "img pallas-oracle": mx(imgs["pallas"], imgs["oracle"]),
             "img exact-oracle": mx(imgs["exact"], imgs["oracle"]),
             "img exact-pallas": mx(imgs["exact"], imgs["pallas"])}
    for i, nm in enumerate(("dmeans", "dscales")):
        for a, b in (("tiled", "oracle"), ("pallas", "oracle"),
                     ("exact", "oracle"), ("exact", "pallas")):
            diffs[f"{nm} {a}-{b}"] = mx(grads[a][i], grads[b][i])
    print("img  tiled-oracle max", diffs["img tiled-oracle"],
          "| pallas-oracle max", diffs["img pallas-oracle"],
          "| exact-pallas max", diffs["img exact-pallas"], flush=True)
    for nm in ("dmeans", "dscales"):
        print(f"{nm}: tiled-oracle {diffs[f'{nm} tiled-oracle']:.3e} "
              f"| pallas-oracle {diffs[f'{nm} pallas-oracle']:.3e} "
              f"| exact-pallas {diffs[f'{nm} exact-pallas']:.3e}",
              flush=True)
    fails = []
    for k in ("pallas", "exact"):
        if not diffs[f"img {k}-oracle"] < IMAGE_BAR:
            fails.append(f"img {k}-oracle {diffs[f'img {k}-oracle']:.3e} "
                         f">= {IMAGE_BAR}")
        for nm in ("dmeans", "dscales"):
            bar = GRAD_FACTOR * diffs[f"{nm} tiled-oracle"]
            if not diffs[f"{nm} {k}-oracle"] <= bar:
                fails.append(f"{nm} {k}-oracle "
                             f"{diffs[f'{nm} {k}-oracle']:.3e} > {bar:.3e}")
    print("PASS" if not fails else "FAIL: " + "; ".join(fails), flush=True)
    return {"images": imgs, "grads": grads, "diffs": diffs,
            "passed": not fails, "failures": fails}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", action="store_true",
                    help="then run tools/bench on the same device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scene = make_toy_scene(seed=0, n=1024, n_cameras=1, width=128, height=96,
                           device=dev)
    res = parity(scene, torch.tensor([0.3, 0.5, 0.7], device=dev))
    if args.bench:
        from . import bench
        res["bench"] = bench.main(["--device", args.device])
    return res


if __name__ == "__main__":
    main()
