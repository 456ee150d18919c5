"""Match-pair generation for COLMAP — ``make_colmap_custom_matcher.py`` and
``make_colmap_custom_matcher_distance.py`` equivalents.

Global matcher (``:71-140``): for every image, sequential neighbors within
its camera folder, quadratic (2^k) temporal jumps, and the 25 nearest
neighbors by GPS position.  Distance matcher (per chunk): the ``n_neighbors``
closest images by camera-center distance.  Output: a text file with one
``nameA nameB`` pair per line, consumable by ``colmap matches_importer``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data import colmap


def _write_pairs(pairs: set[tuple[str, str]], out_path) -> list[str]:
    lines = [f"{a} {b}" for a, b in sorted(pairs)]
    Path(out_path).write_text("\n".join(lines) + "\n")
    return lines


def make_matcher_pairs(positions: dict[str, np.ndarray], out_path,
                       n_seq: int = 5, n_quad: int = 8,
                       n_gps: int = 25) -> list[str]:
    """Global pairs from per-image positions (GPS / recording XY).

    ``positions``: {image_name: [2 or 3] position}, iteration order = temporal
    order within each camera folder (the reference sorts file listings)."""
    names = list(positions)
    by_folder: dict[str, list[str]] = {}
    for n in names:
        by_folder.setdefault(n.split("/")[0] if "/" in n else "", []).append(n)

    pairs: set[tuple[str, str]] = set()

    def add(a: str, b: str):
        if a != b:
            pairs.add((a, b) if a < b else (b, a))

    for folder_names in by_folder.values():
        for i, a in enumerate(folder_names):
            for d in range(1, n_seq + 1):           # sequential neighbors
                if i + d < len(folder_names):
                    add(a, folder_names[i + d])
            for k in range(1, n_quad + 1):          # quadratic jumps
                j = i + 2 ** k
                if j < len(folder_names):
                    add(a, folder_names[j])

    pos = np.stack([np.asarray(positions[n], np.float64)[:2]
                    for n in names])
    d2 = np.sum((pos[:, None] - pos[None, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :n_gps]
    for i, a in enumerate(names):
        for j in nn[i]:
            add(a, names[j])
    return _write_pairs(pairs, out_path)


def make_distance_pairs(sparse_dir, out_path,
                        n_neighbors: int = 200) -> list[str]:
    """Per-chunk pairs by camera-center distance (the distance matcher used
    by ``prepare_chunk.py`` with 200 pairs and ``ss_make_chunk`` with 50)."""
    _, images, _ = colmap.read_model(sparse_dir)
    names = [im.name for im in images.values()]
    centers = np.stack([
        -colmap.qvec2rotmat(im.qvec).T @ im.tvec for im in images.values()])
    d2 = np.sum((centers[:, None] - centers[None, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    k = min(n_neighbors, len(names) - 1)
    nn = np.argsort(d2, axis=1)[:, :k]
    pairs: set[tuple[str, str]] = set()
    for i, a in enumerate(names):
        for j in nn[i]:
            b = names[j]
            pairs.add((a, b) if a < b else (b, a))
    return _write_pairs(pairs, out_path)
