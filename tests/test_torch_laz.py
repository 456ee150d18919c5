"""PyTorch port, LAS/LAZ IO (``preprocess/laz.py`` on the port's copy of the
LASzip codec, ``hostsrc/laz_codec.cpp``): the JAX tests' round trips
through the port, each file written by the port byte-identical to the JAX
package's, and files written by either package read equal by the other;
the chunker's LiDAR read and voxel downsample against JAX's."""

import numpy as np
import pytest

from street_sparse_3dgs_tpu.preprocess import chunk as jchunk
from street_sparse_3dgs_tpu.preprocess import laz as jlaz
from street_sparse_3dgs_tpu_torch.native import host
from street_sparse_3dgs_tpu_torch.preprocess import chunk as tchunk
from street_sparse_3dgs_tpu_torch.preprocess import laz as tlaz


def street_cloud(n=5000, seed=0, with_rgb=True):
    """tests/test_laz.py's random-walk cloud (its own copy)."""
    rng = np.random.default_rng(seed)
    xyz = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    xyz[:, 2] = np.abs(xyz[:, 2]) * 0.2
    xyz += np.array([1000.0, -2000.0, 30.0])
    rgb = None
    if with_rgb:
        rgb = (np.clip(np.cumsum(rng.normal(0, 2, (n, 3)), axis=0) + 128,
                       0, 255)).astype(np.uint8)
    return xyz, rgb


def cases():
    xyz, rgb = street_cloud(2500, seed=2)
    gps = np.cumsum(np.abs(np.random.default_rng(3).normal(
        1e-4, 1e-5, 2500))) + 300000.0
    xyz_a, rgb_a = street_cloud(500)
    xyz_b, rgb_b = street_cloud(3000, seed=1)
    return {
        "las rgb": ("t.las", xyz_a, dict(rgb=rgb_a, scale=0.001)),
        "laz rgb": ("t.laz", xyz_b, dict(rgb=rgb_b, scale=0.001)),
        "laz gps rgb 3 chunks": ("t.laz", xyz, dict(
            rgb=rgb, gps_time=gps,
            intensity=(np.arange(2500) % 7000).astype(np.uint16),
            classification=(np.arange(2500) % 5 + 2).astype(np.uint8),
            scale=0.001, chunk_size=1000)),
        "laz gps only": ("t.laz", xyz, dict(gps_time=gps, chunk_size=700)),
        "laz point10": ("t.laz", street_cloud(800, seed=4,
                                              with_rgb=False)[0],
                        dict(scale=0.01)),
        "laz empty": ("t.laz", np.zeros((0, 3)), dict()),
    }


CASES = cases()
FIELDS = ("x", "y", "z", "intensity", "classification", "red", "green",
          "blue", "gps_time")


def assert_points_equal(a: dict, b: dict):
    assert a["point_format"] == b["point_format"]
    assert {k for k in a if k in FIELDS} == {k for k in b if k in FIELDS}
    for k in FIELDS:
        if k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_port_writer_is_byte_identical_to_jax(tmp_path, case):
    name, xyz, kw = CASES[case]
    pj = jlaz.write_points(tmp_path / ("j_" + name), xyz, **kw)
    pt = tlaz.write_points(tmp_path / ("t_" + name), xyz, **kw)
    assert pt.read_bytes() == pj.read_bytes()


@pytest.mark.parametrize("case", list(CASES))
def test_files_read_across_packages(tmp_path, case):
    """A file of either package read by the other equals its own read, and
    the round trip keeps the writer's quantised values."""
    name, xyz, kw = CASES[case]
    pj = jlaz.write_points(tmp_path / ("j_" + name), xyz, **kw)
    pt = tlaz.write_points(tmp_path / ("t_" + name), xyz, **kw)
    assert_points_equal(tlaz.read_points(pj), jlaz.read_points(pj))
    assert_points_equal(jlaz.read_points(pt), tlaz.read_points(pt))
    got = tlaz.read_points(pt)
    if len(xyz):
        atol = 0.6 * np.max(kw.get("scale", 0.001))
        np.testing.assert_allclose(np.stack([got["x"], got["y"], got["z"]],
                                            1), xyz, atol=atol)
    if "gps_time" in kw:
        np.testing.assert_array_equal(got["gps_time"].view(np.uint64),
                                      kw["gps_time"].view(np.uint64))
    if "rgb" in kw:
        np.testing.assert_array_equal(
            got["red"], kw["rgb"][:, 0].astype(np.uint16) * 257)


def test_laz_compresses_and_matches_raw(tmp_path):
    """The .laz holds the same values as the raw .las and is smaller."""
    xyz, rgb = street_cloud(3000, seed=1)
    p = tlaz.write_points(tmp_path / "t.laz", xyz, rgb=rgb, scale=0.001)
    las = tlaz.write_points(tmp_path / "t.las", xyz, rgb=rgb, scale=0.001)
    assert p.stat().st_size < las.stat().st_size * 0.8
    assert_points_equal(tlaz.read_points(p), tlaz.read_points(las))


def test_codec_builds_from_the_port_sources():
    """The codec library is the port's own build of ``hostsrc`` (a copy of
    the JAX package's source, byte for byte)."""
    from pathlib import Path

    import street_sparse_3dgs_tpu.native as jnative

    jsrc = Path(jnative.__file__).parent / "laz_codec.cpp"
    assert (host.HOSTSRC / "laz_codec.cpp").read_bytes() == jsrc.read_bytes()
    assert (host.HOSTSRC / "ctm_exporter.cpp").read_bytes() == \
        (jsrc.parent / "ctm_exporter.cpp").read_bytes()
    assert host.build("laz_codec").exists()
    assert host.library_path("laz_codec").parent == host.BUILD_DIR


def test_lidar_tiles_and_downsample_match_jax(tmp_path):
    """``load_lidar_tiles`` (LAZ and npz tiles, a chunk box that clips)
    and ``voxel_downsample`` (the keyed unique) equal JAX's."""
    xyz, rgb = street_cloud(4000, seed=5)
    xyz -= np.array([1000.0, -2000.0, 30.0])
    tlaz.write_points(tmp_path / "a.laz", xyz, rgb=rgb, scale=0.001)
    rng = np.random.default_rng(6)
    np.savez(tmp_path / "b.npz", xyz=rng.uniform(-2, 2, (3000, 3)).astype(
        np.float32), rgb=rng.uniform(0, 1, (3000, 3)).astype(np.float32))
    lo = np.array([-1.0, -1.5, -1e9])
    hi = np.array([1.5, 2.0, 1e9])
    for density in (1e12, 50.0, 2000.0):
        a = jchunk.load_lidar_tiles(tmp_path, lo, hi, density)
        b = tchunk.load_lidar_tiles(tmp_path, lo, hi, density)
        c = tchunk.load_lidar_tiles(tmp_path, lo, hi, density,
                                    tchunk.read_lidar_tiles(tmp_path))
        for got in (b, c):
            np.testing.assert_array_equal(got[0], a[0])
            np.testing.assert_array_equal(got[1], a[1])
    pts = rng.normal(0, 3, (20000, 3))
    pts[::3] = pts[1::3]                     # duplicate cells
    for density in (0.5, 30.0, 1e4):
        a = jchunk.voxel_downsample(pts, pts * 2, density)
        b = tchunk.voxel_downsample(pts, pts * 2, density)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
