"""Depth-Anything(-V2) monocular depth as a PyTorch module.

The counterpart of ``street_sparse_3dgs_tpu/preprocess/depth_anything_jax.py``:
a DINOv2 ViT backbone and a DPT neck and head, ``DAV2Config``'s fields
(vits, vitb and vitl widths), computed in float32 with TF32 off (the JAX
module asks for ``Precision.HIGHEST``) and plain attention
(softmax(Q K^T / sqrt(d)) V), as JAX computes it.  No Pallas kernel lies on
this path in the JAX package, so ``F.conv2d`` / ``torch.matmul`` are the
port's counterparts.

* ``DepthAnything``: the module; its ``state_dict`` names follow the JAX
  param pytree (``convert.depth_anything_from_numpy`` turns that pytree
  into this state).
* ``convert_state_dict``: a torch ``state_dict`` in either published naming
  (HuggingFace ``backbone.* / neck.* / head.*`` or the original repo's
  ``pretrained.* / depth_head.*``) -> this module's state; ``infer_config``
  recovers the architecture from it.
* ``load_checkpoint(path)``: a checkpoint from disk only (``.pth``/``.pt``/
  ``.bin`` through ``torch.load``, or a converted ``.npz``); no downloads.
* ``preprocess_image`` / ``infer_inverse_depth``: the DA-V2 inference
  transform and the map back at the input size, with ``jax.image.resize``'s
  bilinear weights (antialiased when downsampling, renormalised at the
  borders), not ``F.interpolate``'s.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class DAV2Config:
    hidden: int = 384            # ViT width (vits=384, vitb=768, vitl=1024)
    layers: int = 12             # transformer depth
    heads: int = 6
    patch: int = 14
    out_indices: tuple = (2, 5, 8, 11)       # blocks whose output feeds DPT
    neck_sizes: tuple = (48, 96, 192, 384)   # reassemble channel widths
    fusion: int = 64             # DPT fusion width (vits=64, vitl=256)
    head_hidden: int = 32
    layernorm_eps: float = 1e-6


VITL = DAV2Config(hidden=1024, layers=24, heads=16,
                  out_indices=(4, 11, 17, 23),
                  neck_sizes=(256, 512, 1024, 1024), fusion=256)


# ---------------------------------------------------------------- resizes


def jax_linear_weights(n_in: int, n_out: int,
                       device=None) -> torch.Tensor:
    """[n_out, n_in] float32 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis (``scale_and_translate`` with the
    triangle kernel, antialias on): sample i at (i + 0.5) n_in / n_out -
    0.5; the kernel widened by n_in / n_out when downsampling; each row
    normalised by its sum (taps outside the input dropped); rows whose
    sample lies outside the input zeroed."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f = torch.float32
    sample = (torch.arange(n_out, dtype=f, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=f, device=device)[:, None]) / kscale
    w = torch.clamp(1.0 - x, min=0.0)                       # [n_in, n_out]
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def resize_bilinear_jax(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``jax.image.resize(x, (..., oh, ow), "bilinear")`` of the last two
    axes of ``x`` (float32, full precision products)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) != (oh, ow):
        wy = jax_linear_weights(h, oh, x.device)
        wx = jax_linear_weights(w, ow, x.device)
        if h != oh:
            x = torch.matmul(wy, x)
        if w != ow:
            x = torch.matmul(x, wx.T)
    return x


# ---------------------------------------------------------------- module


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.proj = (nn.Linear(d, d) for _ in
                                             range(4))

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class _Block(nn.Module):
    def __init__(self, cfg: DAV2Config):
        super().__init__()
        d = cfg.hidden
        self.norm1 = nn.LayerNorm(d, eps=cfg.layernorm_eps)
        self.attn = _Attention(d, cfg.heads)
        self.ls1 = nn.Parameter(torch.ones(d))
        self.norm2 = nn.LayerNorm(d, eps=cfg.layernorm_eps)
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)
        self.ls2 = nn.Parameter(torch.ones(d))

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + h * self.ls2


class _Residual(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _Fusion(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.res1 = _Residual(c)
        self.res2 = _Residual(c)
        self.proj = nn.Conv2d(c, c, 1)


class _Embed(nn.Module):
    def __init__(self, cfg: DAV2Config, grid: int):
        super().__init__()
        self.patch = nn.Conv2d(3, cfg.hidden, cfg.patch, stride=cfg.patch)
        self.cls = nn.Parameter(torch.zeros(1, cfg.hidden))
        self.pos = nn.Parameter(torch.zeros(1, 1 + grid * grid, cfg.hidden))


class _Head(nn.Module):
    def __init__(self, cfg: DAV2Config):
        super().__init__()
        self.conv1 = nn.Conv2d(cfg.fusion, cfg.fusion // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(cfg.fusion // 2, cfg.head_hidden, 3,
                               padding=1)
        self.conv3 = nn.Conv2d(cfg.head_hidden, 1, 1)


class DepthAnything(nn.Module):
    """DINOv2 ViT + DPT: ``forward(pixels [B, 3, H, W])`` (ImageNet
    normalised, H and W multiples of the patch) -> relative inverse depth
    [B, H, W] (larger = closer).  ``grid`` is the side of the checkpoint's
    position grid (37 for the published 518-pixel models)."""

    def __init__(self, cfg: DAV2Config, grid: int = 37):
        super().__init__()
        self.cfg = cfg
        self.embed = _Embed(cfg, grid)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))
        self.final_norm = nn.LayerNorm(cfg.hidden, eps=cfg.layernorm_eps)
        self.project = nn.ModuleList(nn.Conv2d(cfg.hidden, c, 1)
                                     for c in cfg.neck_sizes)
        n = cfg.neck_sizes
        self.resize = nn.ModuleDict({
            "0": nn.ConvTranspose2d(n[0], n[0], 4, stride=4),
            "1": nn.ConvTranspose2d(n[1], n[1], 2, stride=2),
            "3": nn.Conv2d(n[3], n[3], 3, stride=2, padding=1)})
        self.rn = nn.ModuleList(nn.Conv2d(c, cfg.fusion, 3, padding=1,
                                          bias=False) for c in n)
        self.fusion = nn.ModuleList(_Fusion(cfg.fusion) for _ in range(4))
        self.head = _Head(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, _, h, w = pixels.shape
        ph, pw = h // cfg.patch, w // cfg.patch
        x = self.embed.patch(pixels).reshape(b, cfg.hidden, ph * pw)
        x = torch.cat([self.embed.cls.expand(b, 1, cfg.hidden),
                       x.transpose(1, 2)], dim=1)
        pos = self.embed.pos
        if pos.shape[1] != x.shape[1]:
            side = int(round(math.sqrt(pos.shape[1] - 1)))
            # DINOv2's position-grid resampling: torch's bicubic (A =
            # -0.75, half-pixel centres, replicated borders), which the JAX
            # module reimplements.
            grid = pos[:, 1:].reshape(1, side, side, cfg.hidden)
            grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(ph, pw),
                                 mode="bicubic", align_corners=False)
            pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(
                1, ph * pw, cfg.hidden)], dim=1)
        x = x + pos
        feats = []
        want = set(cfg.out_indices)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                feats.append(x)
        maps = []
        for i, f in enumerate(feats):
            f = self.final_norm(f)
            fmap = f[:, 1:].transpose(1, 2).reshape(b, cfg.hidden, ph, pw)
            fmap = self.project[i](fmap)
            if str(i) in self.resize:
                fmap = self.resize[str(i)](fmap)
            maps.append(self.rn[i](fmap))
        fused = None
        for i in (3, 2, 1, 0):
            fl = self.fusion[i]
            fused = maps[i] if fused is None else fused + fl.res1(maps[i])
            fused = fl.res2(fused)
            size = maps[i - 1].shape[2:] if i > 0 else \
                (fused.shape[2] * 2, fused.shape[3] * 2)
            fused = F.interpolate(fused, size=tuple(size), mode="bilinear",
                                  align_corners=True)
            fused = fl.proj(fused)
        out = self.head.conv1(fused)
        out = F.interpolate(out, size=(ph * cfg.patch, pw * cfg.patch),
                            mode="bilinear", align_corners=True)
        out = F.relu(self.head.conv2(out))
        out = F.relu(self.head.conv3(out))
        return out[:, 0]


# ----------------------------------------------------------- conversion


def _key_map(sd: dict, cfg: DAV2Config) -> dict:
    """{module key: (source key, row slice or None)} for a state dict in
    either published naming."""
    hf = any(k.startswith("backbone.") for k in sd)
    m = {}

    def lin(dst, src, rows=None):
        m[dst + ".weight"] = (src + ".weight", rows)
        m[dst + ".bias"] = (src + ".bias", rows)

    d = cfg.hidden
    if hf:
        e = "backbone.embeddings."
        m["embed.cls"] = (e + "cls_token", "squeeze0")
        m["embed.pos"] = (e + "position_embeddings", None)
        lin("embed.patch", e + "patch_embeddings.projection")
        for i in range(cfg.layers):
            p, q = f"backbone.encoder.layer.{i}.", f"blocks.{i}."
            lin(q + "norm1", p + "norm1")
            for a, b in (("q", "query"), ("k", "key"), ("v", "value")):
                lin(q + "attn." + a, p + "attention.attention." + b)
            lin(q + "attn.proj", p + "attention.output.dense")
            m[q + "ls1"] = (p + "layer_scale1.lambda1", None)
            lin(q + "norm2", p + "norm2")
            lin(q + "fc1", p + "mlp.fc1")
            lin(q + "fc2", p + "mlp.fc2")
            m[q + "ls2"] = (p + "layer_scale2.lambda1", None)
        lin("final_norm", "backbone.layernorm")
        for i in range(4):
            lin(f"project.{i}", f"neck.reassemble_stage.layers.{i}.projection")
            m[f"rn.{i}.weight"] = (f"neck.convs.{i}.weight", None)
        for i in (0, 1, 3):
            lin(f"resize.{i}", f"neck.reassemble_stage.layers.{i}.resize")
        # HF fusion_stage.layers run top-down: layers.0 takes the deepest
        # map, the module's fusion.3.
        for i, j in zip(range(4), (3, 2, 1, 0)):
            f = f"neck.fusion_stage.layers.{j}."
            lin(f"fusion.{i}.proj", f + "projection")
            for r in (1, 2):
                for c in (1, 2):
                    lin(f"fusion.{i}.res{r}.conv{c}",
                        f + f"residual_layer{r}.convolution{c}")
        for c in (1, 2, 3):
            lin(f"head.conv{c}", f"head.conv{c}")
    else:
        m["embed.cls"] = ("pretrained.cls_token", "squeeze0")
        m["embed.pos"] = ("pretrained.pos_embed", None)
        lin("embed.patch", "pretrained.patch_embed.proj")
        for i in range(cfg.layers):
            p, q = f"pretrained.blocks.{i}.", f"blocks.{i}."
            lin(q + "norm1", p + "norm1")
            for j, a in enumerate("qkv"):
                lin(q + "attn." + a, p + "attn.qkv", (j * d, (j + 1) * d))
            lin(q + "attn.proj", p + "attn.proj")
            m[q + "ls1"] = (p + "ls1.gamma", None)
            lin(q + "norm2", p + "norm2")
            lin(q + "fc1", p + "mlp.fc1")
            lin(q + "fc2", p + "mlp.fc2")
            m[q + "ls2"] = (p + "ls2.gamma", None)
        lin("final_norm", "pretrained.norm")
        for i in range(4):
            lin(f"project.{i}", f"depth_head.projects.{i}")
            m[f"rn.{i}.weight"] = (
                f"depth_head.scratch.layer{i + 1}_rn.weight", None)
        for i in (0, 1, 3):
            lin(f"resize.{i}", f"depth_head.resize_layers.{i}")
        for i in range(4):
            f = f"depth_head.scratch.refinenet{i + 1}."
            lin(f"fusion.{i}.proj", f + "out_conv")
            for r in (1, 2):
                for c in (1, 2):
                    lin(f"fusion.{i}.res{r}.conv{c}",
                        f + f"resConfUnit{r}.conv{c}")
        lin("head.conv1", "depth_head.scratch.output_conv1")
        lin("head.conv2", "depth_head.scratch.output_conv2.0")
        lin("head.conv3", "depth_head.scratch.output_conv2.2")
    return m


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def infer_config(sd: dict, heads: int | None = None) -> DAV2Config:
    """The architecture from a state dict in either naming (the JAX
    module's rule: heads from the width unless given, the four taps evenly
    spaced over the depth)."""
    hf = any(k.startswith("backbone.") for k in sd)
    pre = "backbone.encoder.layer." if hf else "pretrained.blocks."
    layers = 1 + max(int(mt.group(1)) for k in sd
                     if (mt := re.match(re.escape(pre) + r"(\d+)\.", k)))
    hidden = _tensor(sd["backbone.embeddings.cls_token" if hf
                        else "pretrained.cls_token"]).shape[-1]
    proj = ("neck.reassemble_stage.layers.{}.projection.weight" if hf
            else "depth_head.projects.{}.weight")
    neck = tuple(_tensor(sd[proj.format(i)]).shape[0] for i in range(4))
    fusion = _tensor(sd["neck.convs.0.weight" if hf else
                        "depth_head.scratch.layer1_rn.weight"]).shape[0]
    # The head's hidden width is conv2's output (32 in the published
    # models); the JAX module reads conv1's, which its forward never uses.
    head_hidden = _tensor(sd["head.conv2.weight" if hf else
                             "depth_head.scratch.output_conv2.0.weight"]
                          ).shape[0]
    patch = _tensor(sd["backbone.embeddings.patch_embeddings.projection"
                       ".weight" if hf else
                       "pretrained.patch_embed.proj.weight"]).shape[-1]
    if heads is None:
        heads = {384: 6, 768: 12, 1024: 16}.get(hidden, max(1, hidden // 64))
    step = layers // 4
    return DAV2Config(hidden=hidden, layers=layers, heads=heads, patch=patch,
                      out_indices=tuple(step * (i + 1) - 1 for i in range(4)),
                      neck_sizes=neck, fusion=fusion,
                      head_hidden=head_hidden)


def convert_state_dict(sd: dict, cfg: DAV2Config | None = None):
    """A published state dict (either naming) -> (this module's state dict
    of float32 CPU tensors, cfg)."""
    if cfg is None:
        cfg = infer_config(sd)
    out = {}
    for dst, (src, rows) in _key_map(sd, cfg).items():
        t = _tensor(sd[src])
        if rows == "squeeze0":
            t = t[0]
        elif rows is not None:
            t = t[rows[0]:rows[1]]
        out[dst] = t.contiguous()
    return out, cfg


def to_original_naming(state: dict, cfg: DAV2Config) -> dict:
    """This module's state -> a state dict in the original Depth-Anything-V2
    repo's naming (``pretrained.* / depth_head.*``, q, k and v stacked as
    ``attn.qkv``): what ``convert_state_dict`` reads back."""
    out, qkv = {}, {}
    for dst, (src, rows) in _key_map({}, cfg).items():
        t = state[dst].detach().to("cpu", torch.float32)
        if rows == "squeeze0":
            out[src] = t[None].clone()
        elif rows is not None:
            qkv.setdefault(src, {})[rows[0]] = t
        else:
            out[src] = t.clone()
    for src, parts in qkv.items():
        out[src] = torch.cat([parts[k] for k in sorted(parts)])
    return out


def random_state(cfg: DAV2Config, grid: int, seed: int) -> dict:
    """A state for ``DepthAnything(cfg, grid)`` drawn with numpy from
    ``seed``, scaled so that activations stay of order one at any width
    (weights N(0, 1/fan_in), LayerNorm scales near 1, layer scales near
    0.5, the head's last bias positive): random weights for the runs that
    have no published checkpoint."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  DepthAnything(cfg, grid).state_dict().items()}
    state = {}
    for k, shape in shapes.items():
        v = rng.standard_normal(shape, dtype=np.float32)
        if k.endswith(".weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            if "resize.0" in k or "resize.1" in k:   # (in, out, kh, kw)
                fan_in = shape[0]
            v *= np.float32(1.0 / math.sqrt(fan_in))
        elif "norm" in k and k.endswith(".weight"):
            v = 1.0 + 0.1 * v
        elif k.endswith((".ls1", ".ls2")):
            v = 0.5 + 0.1 * v
        elif k in ("embed.cls", "embed.pos"):
            v *= np.float32(0.5)
        else:
            v *= np.float32(0.1)
        state[k] = torch.from_numpy(v)
    state["head.conv3.bias"].fill_(0.5)
    return state


def build_model(state: dict, cfg: DAV2Config,
                device=DEFAULT_DEVICE) -> DepthAnything:
    """The module on ``device`` (eval mode) with ``state`` loaded
    strictly; TF32 off (``train.losses.tf32_off``) for its products."""
    from ..train.losses import tf32_off

    tf32_off()
    grid = int(round(math.sqrt(state["embed.pos"].shape[1] - 1)))
    with torch.device("meta"):          # no initialisation to overwrite
        model = DepthAnything(cfg, grid)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(resolve_device(device)).eval()


def load_checkpoint(path, device=DEFAULT_DEVICE):
    """(model, cfg) from a Depth-Anything checkpoint file on disk:
    ``.pth``/``.pt``/``.bin`` (``torch.load``, weights only) or a converted
    ``.npz``, in either published naming."""
    path = str(path)
    if path.endswith(".npz"):
        sd = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    state, cfg = convert_state_dict(sd)
    return build_model(state, cfg, device), cfg


# ----------------------------------------------------------- inference

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_image(img_hw3: np.ndarray, target: int = 518,
                     device=DEFAULT_DEVICE):
    """uint8/float HWC RGB -> normalised [1, 3, H', W'] on ``device``, H',
    W' the nearest multiples of 14 after scaling the short side to
    ``target`` (the DA-V2 inference transform, JAX's resize weights)."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img_hw3, np.float32), device=dev)
    if float(img.max()) > 1.5:
        img = img / 255.0
    h, w = img.shape[:2]
    scale = target / min(h, w)
    nh = max(14, int(round(h * scale / 14)) * 14)
    nw = max(14, int(round(w * scale / 14)) * 14)
    x = resize_bilinear_jax(img.permute(2, 0, 1), (nh, nw))   # [3, nh, nw]
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=dev)[:, None, None]
    return ((x - mean) / std)[None], (h, w)


@torch.no_grad()
def infer_inverse_depth(model: DepthAnything, img_hw3: np.ndarray,
                        target: int = 518) -> torch.Tensor:
    """One image end to end, back at the input size: [H, W] float32 on the
    model's device, TF32 off (``train.losses.tf32_off``)."""
    from ..train.losses import tf32_off

    tf32_off()
    dev = next(model.parameters()).device
    x, (h, w) = preprocess_image(img_hw3, target, dev)
    d = model(x)[0]
    return resize_bilinear_jax(d, (h, w))
