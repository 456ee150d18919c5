"""Synthetic scenes, mirroring ``street_sparse_3dgs_tpu/data/toy.py``.

``lookat_camera`` and ``make_street_scene`` draw from numpy in the same
order as the JAX package, so the same seed gives the same scene in both.
The JAX ``make_toy_scene`` draws from ``jax.random``, which torch cannot
reproduce: the port's ``make_toy_scene`` has the same distributions and
cameras from its own seeded ``torch.Generator``, and tests that need the
JAX scene convert it through ``convert``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.camera import CameraParams, make_camera
from ..device import DEFAULT_DEVICE, resolve_device


class ToyScene(NamedTuple):
    means3d: torch.Tensor      # [N, 3]
    scales: torch.Tensor       # [N, 3] activated (positive)
    quats: torch.Tensor        # [N, 4]
    opacities: torch.Tensor    # [N] activated (0, 1)
    sh_coeffs: torch.Tensor    # [N, K, 3]
    cameras: list[CameraParams]


def lookat_camera(pos: np.ndarray, target: np.ndarray, width: int,
                  height: int, fovx: float = math.radians(60.0),
                  up=np.array([0.0, 0.0, 1.0]),
                  device: str | torch.device = DEFAULT_DEVICE) -> CameraParams:
    """Camera looking from ``pos`` to ``target`` (+z forward, +y down camera
    frame, 3DGS convention)."""
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-6:  # forward parallel to up: pick another up
        right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
        nr = np.linalg.norm(right)
    right = right / nr
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd])           # world->camera rotation rows
    t = -R_wc @ pos
    fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
    return make_camera(R_wc.T, t, fovx, fovy, width, height, device=device)


def make_street_scene(seed: int = 0, n: int = 1_000_000, n_cameras: int = 4,
                      width: int = 1920, height: int = 1088,
                      sh_degree: int = 3, length: float = 120.0,
                      half_width: float = 12.0,
                      device: str | torch.device = DEFAULT_DEVICE) -> ToyScene:
    """Street-profile synthetic scene at production scale: a ground strip,
    two building facades, clustered street objects and a sparse far
    background, with log-uniform angular splat sizes and cameras at vehicle
    height looking down the road (see the JAX docstring for the rationale).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.40)
    n_facade = int(n * 0.40)
    n_obj = int(n * 0.15)
    n_far = n - n_ground - n_facade - n_obj

    def jitter(k, s):
        return rng.normal(0.0, s, k)

    g_xy = np.stack([rng.uniform(0.0, length, n_ground),
                     rng.uniform(-half_width, half_width, n_ground)], axis=1)
    ground = np.concatenate([g_xy, np.abs(jitter(n_ground, 0.03))[:, None]],
                            axis=1)
    side = rng.integers(0, 2, n_facade) * 2 - 1
    facade = np.stack([
        rng.uniform(0.0, length, n_facade),
        side * half_width + jitter(n_facade, 0.15),
        rng.uniform(0.0, 14.0, n_facade)], axis=1)
    n_clusters = max(1, n_obj // 2000)
    centers = np.stack([
        rng.uniform(0.0, length, n_clusters),
        rng.uniform(-half_width * 0.8, half_width * 0.8, n_clusters),
        rng.uniform(0.3, 3.0, n_clusters)], axis=1)
    which = rng.integers(0, n_clusters, n_obj)
    objs = centers[which] + rng.normal(0.0, 0.8, (n_obj, 3)) * \
        np.array([1.5, 0.6, 0.8])
    objs[:, 2] = np.abs(objs[:, 2])
    far = np.stack([
        rng.uniform(length, length * 1.6, n_far),
        rng.uniform(-6 * half_width, 6 * half_width, n_far),
        rng.uniform(0.0, 30.0, n_far)], axis=1)

    means = np.concatenate([ground, facade, objs, far]).astype(np.float32)

    t_ax = np.clip(means[:, 0], 0.0, length)
    d_ax = np.sqrt((means[:, 0] - t_ax) ** 2 + means[:, 1] ** 2
                   + (means[:, 2] - 2.2) ** 2)
    d_ax = np.clip(d_ax, 1.5, 300.0)
    theta = np.exp(rng.uniform(np.log(1e-3), np.log(6e-3), (n, 3)))
    base = (d_ax[:, None] * theta).astype(np.float32)
    base[:n_ground, 2] *= 0.15
    base[n_ground:n_ground + n_facade, 1] *= 0.15
    base[-n_far:] *= 2.0
    quats = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.beta(4.0, 1.5, n).astype(np.float32) * 0.98 + 0.01
    k = (sh_degree + 1) ** 2
    sh = (0.12 * rng.normal(0.0, 1.0, (n, k, 3))).astype(np.float32)
    sh[:, 0, :] = rng.uniform(-1.2, 1.2, (n, 3))

    cams = []
    for i in range(n_cameras):
        x = 8.0 + (length - 40.0) * i / max(n_cameras - 1, 1)
        pos = np.array([x, rng.uniform(-1.5, 1.5), 2.2])
        target = pos + np.array([20.0, rng.uniform(-4.0, 4.0), -0.8])
        cams.append(lookat_camera(pos, target, width, height,
                                  fovx=math.radians(70.0), device=dev))

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    return ToyScene(t(means), t(base), t(quats), t(opac), t(sh), cams)


def random_gaussians(generator: torch.Generator, n: int, sh_degree: int = 3,
                     extent: float = 1.0, scale_range=(0.02, 0.12),
                     device: str | torch.device = DEFAULT_DEVICE):
    """(means, scales, quats, opacities, sh) of ``n`` random Gaussians in
    the cube [-extent, extent]^3, the distributions of the JAX function,
    drawn on the CPU from ``generator`` and moved to ``device``."""
    dev = resolve_device(device)
    g = generator
    means = (torch.rand((n, 3), generator=g) * 2.0 - 1.0) * extent
    lo, hi = scale_range
    scales = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    quats = torch.randn((n, 4), generator=g)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    opac = 0.3 + 0.65 * torch.rand((n,), generator=g)
    k = (sh_degree + 1) ** 2
    sh = 0.3 * torch.randn((n, k, 3), generator=g)
    # Bias the DC band so mean colors land in a visible range.
    sh[:, 0, :] = torch.rand((n, 3), generator=g) * 2.0 - 1.0
    return tuple(x.to(dev) for x in (means, scales, quats, opac, sh))


def make_toy_scene(seed: int = 0, n: int = 512, n_cameras: int = 4,
                   width: int = 64, height: int = 64, sh_degree: int = 3,
                   radius: float = 3.0,
                   device: str | torch.device = DEFAULT_DEVICE) -> ToyScene:
    """A random Gaussian cube seen by ``n_cameras`` cameras on a circle of
    ``radius`` around it (the JAX scene's layout; its draws come from a
    ``torch.Generator`` seeded with ``seed``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    rows = random_gaussians(gen, n, sh_degree, device=dev)
    cams = []
    for i in range(n_cameras):
        ang = 2.0 * math.pi * i / max(n_cameras, 1)
        pos = np.array([radius * math.cos(ang), radius * math.sin(ang), 0.8])
        cams.append(lookat_camera(pos, np.zeros(3), width, height,
                                  device=dev))
    return ToyScene(*rows, cams)
