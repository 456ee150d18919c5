"""Rows for the projection's tests (``tests/test_torch_project.py`` on the
CPU, ``tests/test_torch_project_card.py`` on the card): a street camera and
rows in and around its view with every edge case the chain branches on."""

import math

import numpy as np
import torch


def street_camera(dev, width=1920, height=1088):
    """A camera at the street's start, 2.2 m up, looking down the road."""
    from street_sparse_3dgs_tpu_torch.data.toy import lookat_camera
    return lookat_camera(np.array([8.0, 0.5, 2.2]),
                         np.array([28.0, -1.0, 1.4]), width, height,
                         fovx=math.radians(70.0), device=dev)


def camera_as(cam, dtype):
    """``cam`` with its tensors in ``dtype``."""
    return cam._replace(**{f: getattr(cam, f).to(dtype) for f in (
        "viewmatrix", "projmatrix", "campos", "tan_fovx", "tan_fovy",
        "focal_x", "focal_y")})


def edge_rows(seed: int, n: int, k: int, cam, dev, dtype=torch.float32):
    """``n`` rows in and around ``cam``'s view with, at fixed places, what
    the chain has to get right: rows behind the near plane, rank-1
    covariances behind the camera and off-axis (the clamped Jacobian makes
    ``det`` cancel to <= 0 in some), rows past the 1.3 tan-fov clamp, off
    the image, a zero quaternion, a row at the camera centre, colours below
    zero before the clamp, and an inactive mask on a tenth of the rows.
    Returns (means3d, scales, quats, opacities, sh [n, k, 3], mask)."""
    rng = np.random.default_rng(seed)
    view = cam.viewmatrix.cpu().numpy().astype(np.float64)
    c2w = np.linalg.inv(view)
    depth = rng.uniform(0.5, 60.0, n)
    tan_x = float(cam.tan_fovx)
    tan_y = float(cam.tan_fovy)
    cam_pts = np.stack([rng.uniform(-1.6, 1.6, n) * tan_x * depth,
                        rng.uniform(-1.6, 1.6, n) * tan_y * depth, depth], 1)
    m = n // 16
    cam_pts[:m, 2] = rng.uniform(-5.0, 0.2, m)                 # behind
    cam_pts[m:2 * m, 0] = rng.choice([-1, 1], m) * rng.uniform(
        1.31, 4.0, m) * tan_x * cam_pts[m:2 * m, 2]          # past the clamp
    cam_pts[2 * m:3 * m, 1] = rng.choice([-1, 1], m) * rng.uniform(
        1.31, 4.0, m) * tan_y * cam_pts[2 * m:3 * m, 2]
    cam_pts[3 * m:4 * m, 2] = -rng.uniform(0.5, 5.0, m)      # rank 1, behind
    cam_pts[3 * m:4 * m, 0] = rng.choice([-1, 1], m) * rng.uniform(
        2.0, 9.0, m)
    means = (np.concatenate([cam_pts, np.ones((n, 1))], 1) @ c2w.T)[:, :3]
    scales = np.exp(rng.uniform(-4.0, 0.5, (n, 3)))
    scales[3 * m:4 * m, 1:] = 0.0
    scales[3 * m:4 * m, 0] = np.exp(rng.uniform(np.log(1e-3), np.log(1e2),
                                                m))
    quats = rng.normal(0.0, 1.0, (n, 4))
    quats[4 * m] = 0.0                                       # zero quaternion
    quats[4 * m + 1:4 * m + 9] *= rng.uniform(0.01, 100.0, (8, 1))
    means[4 * m + 9] = cam.campos.cpu().numpy()                # camera centre
    opac = rng.uniform(0.01, 0.99, n)
    sh = 0.3 * rng.normal(0.0, 1.0, (n, k, 3))
    sh[:, 0, :] = rng.uniform(-1.2, 1.2, (n, 3))
    sh[5 * m:6 * m, 0, :] = -5.0                               # colour < 0
    mask = rng.random(n) >= 0.1

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return (t(means), t(scales), t(quats), t(opac), t(sh),
            torch.tensor(mask, device=dev))
