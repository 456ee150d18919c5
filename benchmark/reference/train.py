"""Plain PyTorch chunk training: the steps of 3DGS training as the fork
runs them on one chunk, from raw parameter rows.

One step renders a view (``raster``), applies the view's 3x4 exposure
affine and clamps, takes (1 - lambda) L1 + lambda (1 - SSIM) (11x11
Gaussian window, sigma 1.5) against the target plus the scheduled weight
times the masked inverse-depth L1, and moves with Adam: every parameter
group at its own rate (xyz's log-linear with a delayed start), eps 1e-15,
only on rows whose opacity gradient is nonzero, the moments of the other
rows left as they are; the exposure table takes a dense Adam with eps 1e-8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import raster

LEAVES = ("xyz", "features_dc", "features_rest", "log_scales", "quats",
          "opacity_raw")
BETA1, BETA2 = 0.9, 0.999


def expon_lr(step: int, lr_init: float, lr_final: float,
             delay_steps: int = 0, delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    if lr_init == 0.0 or step < 0:
        return 0.0
    delay = 1.0
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)


def _window(device):
    x = torch.arange(11, dtype=torch.float32, device=device) - 5
    g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, tf32: bool) -> torch.Tensor:
    w = _window(img.device)
    x = img[:, None]
    if tf32:
        x, w = raster.tf32_round(x), raster.tf32_round(w)
    x = F.conv2d(x, w.reshape(1, 1, 11, 1), padding=(5, 0))
    if tf32:
        x = raster.tf32_round(x)
    x = F.conv2d(x, w.reshape(1, 1, 1, 11), padding=(0, 5))
    return x[:, 0]


def ssim(a: torch.Tensor, b: torch.Tensor, tf32: bool = False):
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(a, tf32), _blur(b, tf32)
    s11 = _blur(a * a, tf32) - mu1 * mu1
    s22 = _blur(b * b, tf32) - mu2 * mu2
    s12 = _blur(a * b, tf32) - mu1 * mu2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def view_loss(render, inv_depth, exposure, view: dict, opt: dict,
              depth_w: float, tf32: bool = False):
    # img_hwc @ E[:3, :3] + E[:, 3]: output channel k takes E[c, k].
    image = sum(exposure[c, :3, None, None] * render[c] for c in range(3)) \
        + exposure[:, 3, None, None]
    image = image.clamp(0.0, 1.0)
    lam = opt["lambda_dssim"]
    shown = image * view["alpha_mask"]
    photo = (1 - lam) * (shown - view["gt"]).abs().mean() \
        + lam * (1 - ssim(shown, view["gt"], tf32))
    depth = ((inv_depth - view["mono_invdepth"]) * view["depth_mask"]
             ).abs().mean()
    return photo + depth_w * depth


def grads_of(rows: dict, exposure_row, view: dict, bg, opt: dict,
             depth_w: float, sh_degree: int, tf32: bool = False,
             loss_fn=view_loss):
    """(loss, grads of the six raw leaves, grad of the exposure row,
    passing Gaussians) of one view."""
    leaves = {k: rows[k].detach().requires_grad_(True) for k in LEAVES}
    shs = torch.cat([leaves["features_dc"], leaves["features_rest"]], 1)
    p = raster.project(leaves["xyz"], torch.exp(leaves["log_scales"]),
                       leaves["quats"], torch.sigmoid(leaves["opacity_raw"][:, 0]),
                       shs, view["camera"], sh_degree, tf32)
    plan = raster.plan_tiles(p, view["camera"]["height"],
                             view["camera"]["width"])
    attrs = raster.attrs_of(p)
    img, invd, _, passes = raster.render(plan, attrs, bg, tf32)
    img.requires_grad_(True)
    invd.requires_grad_(True)
    e = exposure_row.detach().requires_grad_(True)
    loss = loss_fn(img, invd, e, view, opt, depth_w, tf32)
    d_img, d_invd, d_e = torch.autograd.grad(loss, [img, invd, e])
    d_attrs = raster.backward(plan, attrs, bg, d_img, d_invd, tf32)
    keep = [a for a in attrs if a.requires_grad]
    torch.autograd.backward(keep, [g for a, g in zip(attrs, d_attrs)
                                   if a.requires_grad])
    g = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
         for k, v in leaves.items()}
    return float(loss.detach()), g, d_e, passes


def lrs(opt: dict, it: int, spatial_lr_scale: float) -> dict:
    xyz = expon_lr(it, opt["position_lr_init"] * spatial_lr_scale,
                   opt["position_lr_final"] * spatial_lr_scale,
                   delay_mult=opt["position_lr_delay_mult"],
                   max_steps=opt["position_lr_max_steps"])
    f = opt["feature_lr"]
    return dict(xyz=xyz, features_dc=f, features_rest=f / 20.0,
                log_scales=opt["scaling_lr"], quats=opt["rotation_lr"],
                opacity_raw=opt["opacity_lr"])


def run_steps(rows: dict, views: list, bgs: list, opt: dict,
              spatial_lr_scale: float, sh_degree: int, steps: int,
              tf32: bool = False, loss_fn=view_loss) -> dict:
    """``steps`` training steps from raw rows ``rows`` over ``views`` (one
    a step, each a dict with its camera, targets and ``index``) at
    backgrounds ``bgs``.  Returns the losses, the first step's gradients
    as Adam takes them (the masked rows' zeros included) and the state
    after the last step."""
    raster.full_precision()
    params = {k: rows[k].detach().clone() for k in LEAVES}
    n_images = opt["n_images"]
    dev = params["xyz"].device
    exposure = torch.eye(3, 4, device=dev).expand(n_images, 3, 4).clone()
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(x) for k, x in params.items()}
    em, ev = torch.zeros_like(exposure), torch.zeros_like(exposure)
    out = {"losses": [], "passes": []}
    for s in range(steps):
        it = s + 1
        view, bg = views[s], bgs[s]
        depth_w = expon_lr(it, opt["depth_l1_weight_init"],
                           opt["depth_l1_weight_final"],
                           max_steps=opt["iterations"])
        loss, g, g_e, passes = grads_of(params, exposure[view["index"]], view,
                                        bg, opt, depth_w, sh_degree, tf32,
                                        loss_fn)
        out["losses"].append(loss)
        out["passes"].append(passes)
        relevant = g["opacity_raw"][:, 0] != 0
        bc1, bc2 = 1 - BETA1 ** it, 1 - BETA2 ** it
        rate = lrs(opt, it, spatial_lr_scale)
        for k in LEAVES:
            mask = relevant.reshape((-1,) + (1,) * (params[k].dim() - 1))
            m[k] = torch.where(mask, BETA1 * m[k] + (1 - BETA1) * g[k], m[k])
            v[k] = torch.where(mask, BETA2 * v[k] + (1 - BETA2) * g[k] ** 2,
                               v[k])
            step = rate[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-15)
            params[k] = torch.where(mask, params[k] - step, params[k])
        ge = torch.zeros_like(exposure)
        ge[view["index"]] = g_e
        em = BETA1 * em + (1 - BETA1) * ge
        ev = BETA2 * ev + (1 - BETA2) * ge * ge
        e_lr = expon_lr(it, opt["exposure_lr_init"], opt["exposure_lr_final"],
                        delay_steps=opt["exposure_lr_delay_steps"],
                        delay_mult=opt["exposure_lr_delay_mult"],
                        max_steps=opt["iterations"])
        exposure = exposure - e_lr * (em / bc1) / (torch.sqrt(ev / bc2) + 1e-8)
        if s == 0:
            out["grads"] = {k: torch.where(
                relevant.reshape((-1,) + (1,) * (g[k].dim() - 1)), g[k],
                torch.zeros_like(g[k])) for k in LEAVES}
            out["grads"]["exposure"] = ge
    out["params"] = dict(params, exposure=exposure)
    return out
