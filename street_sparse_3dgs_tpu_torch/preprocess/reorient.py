"""Scene reorientation + metric rescale — ``preprocess/auto_reorient.py`` /
``transform_colmap.py`` equivalents.

``auto_reorient``: least-squares ground-plane fit of the camera centers →
rotation bringing the plane normal to +z (``:20-41,118-141``); metric scale
from the median camera-to-point distance vs ``target_med_dist`` (default
20 m, ``:95-110``).  ``apply_transform`` is the shared rigid+scale model
re-registration (``rotate_camera`` semantics: C2W center is rotated/scaled,
the camera rotation is left-composed with the inverse rotation).
"""

from __future__ import annotations

import numpy as np

from ..data import colmap


def fit_plane(points: np.ndarray):
    """LSQ plane z = a·x + b·y + c → (unit normal, centroid)."""
    A = np.c_[points[:, 0], points[:, 1], np.ones(len(points))]
    (a, b, _), *_ = np.linalg.lstsq(A, points[:, 2], rcond=None)
    n = np.array([a, b, -1.0])
    n /= np.linalg.norm(n)
    if n[2] < 0:
        n = -n
    return n, points.mean(axis=0)


def rotation_to_z_up(normal: np.ndarray) -> np.ndarray:
    """Rotation matrix mapping ``normal`` to +z (Rodrigues)."""
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(normal, z)
    s = np.linalg.norm(v)
    c = float(normal @ z)
    if s < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))


def median_cam_point_distance(images: dict, pts: colmap.ColmapPoints):
    id_to_row = {int(p): r for r, p in enumerate(pts.ids)}
    dists = []
    for im in images.values():
        c = -colmap.qvec2rotmat(im.qvec).T @ im.tvec
        rows = [id_to_row[int(p)] for p in im.point3D_ids
                if p >= 0 and int(p) in id_to_row]
        if rows:
            dists.append(np.linalg.norm(pts.xyz[rows] - c, axis=1))
    if not dists:
        return 1.0
    return float(np.median(np.concatenate(dists)))


def apply_transform(images: dict, pts: colmap.ColmapPoints | None,
                    rot: np.ndarray, scale: float = 1.0):
    """Rigid-rotate + scale the whole model (reference ``rotate_camera``:
    new_center = scale · (centerᵀ rot); cam rotation ← rot⁻¹ · R_c2w)."""
    new_images = {}
    for k, im in images.items():
        R = colmap.qvec2rotmat(im.qvec)
        c2w_rot = R.T
        center = -R.T @ im.tvec
        new_center = scale * (center @ rot)
        new_rot_c2w = np.linalg.inv(rot) @ c2w_rot
        R_new = new_rot_c2w.T
        t_new = -R_new @ new_center
        new_images[k] = colmap.ColmapImage(
            im.id, colmap.rotmat2qvec(R_new), t_new, im.camera_id, im.name,
            im.xys, im.point3D_ids)
    new_pts = None
    if pts is not None:
        new_pts = colmap.ColmapPoints(
            xyz=scale * (pts.xyz @ rot), rgb=pts.rgb, error=pts.error,
            ids=pts.ids, track_image_ids=pts.track_image_ids,
            track_point2d_idxs=pts.track_point2d_idxs)
    return new_images, new_pts


def auto_reorient(input_sparse, output_sparse, target_med_dist: float = 20.0,
                  upscale: float = 0.0):
    """Read a model, align the camera ground plane to z-up and rescale so the
    median camera-to-point distance equals ``target_med_dist``."""
    cams, images, pts = colmap.read_model(input_sparse)
    if upscale == 0.0 and pts is not None:
        med = median_cam_point_distance(images, pts)
        upscale = target_med_dist / max(med, 1e-9)
    elif upscale == 0.0:
        upscale = 1.0
    centers = np.stack([
        -colmap.qvec2rotmat(im.qvec).T @ im.tvec for im in images.values()])
    normal, _ = fit_plane(centers)
    rot = rotation_to_z_up(normal).T   # applied as center @ rot
    new_images, new_pts = apply_transform(images, pts, rot, upscale)
    colmap.write_model(cams, new_images, new_pts, output_sparse)
    return rot, upscale


def simplify_images(input_sparse, output_sparse,
                    outlier_factor: float = 10.0):
    """``preprocess/simplify_images.py`` equivalent: drop cameras without SfM
    points and 3D points farther than ``outlier_factor`` × the median
    nearest-neighbor distance from their closest neighbor."""
    cams, images, pts = colmap.read_model(input_sparse)
    kept_images = {k: im for k, im in images.items()
                   if (im.point3D_ids >= 0).sum() > 0}

    new_pts = pts
    if pts is not None and pts.xyz.shape[0] > 3:
        xyz = pts.xyz
        # Median NN distance on a subsample (simplify_images uses the full
        # cloud; a 50k subsample keeps this O(n·m) step bounded).
        sub = xyz[np.random.default_rng(0).permutation(len(xyz))[:50_000]]
        d2 = ((xyz[:, None, :3] - sub[None, :, :3]) ** 2).sum(-1) \
            if len(xyz) * len(sub) <= 25_000_000 else None
        if d2 is None:
            # blocked NN against the subsample
            nn = np.empty(len(xyz))
            for i in range(0, len(xyz), 4096):
                blk = ((xyz[i:i + 4096, None, :] - sub[None, :, :]) ** 2
                       ).sum(-1)
                blk[blk <= 1e-12] = np.inf
                nn[i:i + 4096] = np.sqrt(blk.min(axis=1))
        else:
            d2[d2 <= 1e-12] = np.inf
            nn = np.sqrt(d2.min(axis=1))
        med = np.median(nn)
        keep = nn <= outlier_factor * med
        keep_ids = set(int(p) for p in pts.ids[keep])
        new_pts = colmap.ColmapPoints(
            xyz=pts.xyz[keep], rgb=pts.rgb[keep], error=pts.error[keep],
            ids=pts.ids[keep],
            track_image_ids=[t for t, k in zip(pts.track_image_ids, keep)
                             if k] if pts.track_image_ids else None,
            track_point2d_idxs=[t for t, k in
                                zip(pts.track_point2d_idxs, keep)
                                if k] if pts.track_point2d_idxs else None)
        # Strip dropped points from the per-image match lists.
        kept_images = {
            k: colmap.ColmapImage(
                im.id, im.qvec, im.tvec, im.camera_id, im.name,
                im.xys[[int(p) in keep_ids for p in im.point3D_ids]],
                im.point3D_ids[[int(p) in keep_ids
                                for p in im.point3D_ids]])
            for k, im in kept_images.items()}
    colmap.write_model(cams, kept_images, new_pts, output_sparse)
    return len(kept_images), 0 if new_pts is None else len(new_pts.ids)
