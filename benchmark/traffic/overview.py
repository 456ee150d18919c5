"""Cameras above and beyond one end of the road: ``poses`` positions
uniform in the boxes ``x``, ``y`` and ``z``, each looking at a point
uniform in the box ``target``, drawn once from ``pose_seed``; the run's
seed orders them, a fresh permutation each pass, so every seed serves the
same set of views.  A request is ``{"pos", "yaw", "pitch"}``."""

import math

import numpy as np


def poses(mix: dict) -> list:
    r = np.random.default_rng(mix["pose_seed"])
    out = []
    for _ in range(mix["poses"]):
        pos = np.array([r.uniform(*mix["x"]), r.uniform(*mix["y"]),
                        r.uniform(*mix["z"])])
        d = np.array([r.uniform(*b) for b in mix["target"]]) - pos
        out.append({"pos": pos, "yaw": math.atan2(d[1], d[0]),
                    "pitch": math.asin(d[2] / np.linalg.norm(d))})
    return out


def more(mix: dict, rng, n_views: int, i: int) -> list:
    """The next pass over the poses."""
    p = poses(mix)
    return [p[k] for k in rng.permutation(len(p))]
