"""PyTorch port, preprocessing (``street_sparse_3dgs_tpu_torch/preprocess``):
each step run by the JAX package and by the port on the same inputs, in
two directories, and the outputs compared file for file — COLMAP models,
JSON, PNGs and CTM meshes byte-identical, or equal as arrays where the
port's own codecs write the file: calibration, virtual views, reorient,
matchers, the COLMAP database, inputs (black_mask), depth decode, depth
scale, chunking with the LiDAR merge, colmap_runner's command sequences
with ``colmap`` absent, and depth_pipeline's local steps with the CTM
writer (native against plain and JAX's)."""

import json
import math
import sqlite3
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from street_sparse_3dgs_tpu.preprocess import calibration as jcal
from street_sparse_3dgs_tpu.preprocess import chunk as jchunk
from street_sparse_3dgs_tpu.preprocess import colmap_db as jdb
from street_sparse_3dgs_tpu.preprocess import colmap_runner as jrunner
from street_sparse_3dgs_tpu.preprocess import depth_decode as jdecode
from street_sparse_3dgs_tpu.preprocess import depth_pipeline as jpipe
from street_sparse_3dgs_tpu.preprocess import depth_scale as jscale
from street_sparse_3dgs_tpu.preprocess import inputs as jinputs
from street_sparse_3dgs_tpu.preprocess import matchers as jmatch
from street_sparse_3dgs_tpu.preprocess import reorient as jreorient
from street_sparse_3dgs_tpu.preprocess import virtual_cams as jvirtual
from street_sparse_3dgs_tpu_torch.data import colmap, png
from street_sparse_3dgs_tpu_torch.native import ctm
from street_sparse_3dgs_tpu_torch.preprocess import calibration as tcal
from street_sparse_3dgs_tpu_torch.preprocess import chunk as tchunk
from street_sparse_3dgs_tpu_torch.preprocess import colmap_db as tdb
from street_sparse_3dgs_tpu_torch.preprocess import colmap_runner as trunner
from street_sparse_3dgs_tpu_torch.preprocess import depth_decode as tdecode
from street_sparse_3dgs_tpu_torch.preprocess import depth_pipeline as tpipe
from street_sparse_3dgs_tpu_torch.preprocess import depth_scale as tscale
from street_sparse_3dgs_tpu_torch.preprocess import inputs as tinputs
from street_sparse_3dgs_tpu_torch.preprocess import matchers as tmatch
from street_sparse_3dgs_tpu_torch.preprocess import reorient as treorient
from street_sparse_3dgs_tpu_torch.preprocess import virtual_cams as tvirtual


def grid_model(n_cams=24, n_pts=300, spread=120.0, seed=0, mod=colmap):
    """tests/test_preprocess.py's street model (its own copy)."""
    rng = np.random.default_rng(seed)
    cams = {1: mod.ColmapCamera(1, "PINHOLE", 64, 48,
                                np.array([60.0, 60.0, 32.0, 24.0]))}
    images = {}
    pts_xyz = rng.uniform([-10, -10, -2], [spread + 10, 10, 5],
                          size=(n_pts, 3))
    pts = mod.ColmapPoints(
        xyz=pts_xyz, rgb=rng.integers(0, 255, (n_pts, 3)).astype(np.uint8),
        error=np.zeros(n_pts), ids=np.arange(n_pts, dtype=np.int64))
    for i in range(n_cams):
        center = np.array([spread * i / (n_cams - 1), 0.0, 1.5])
        near = np.nonzero(np.linalg.norm(pts_xyz - center, axis=1) < 30)[0]
        images[i + 1] = mod.ColmapImage(
            i + 1, mod.rotmat2qvec(np.eye(3)), -center, 1,
            f"img{i:03d}.png", rng.uniform(0, 64, (len(near), 2)),
            near.astype(np.int64))
    return cams, images, pts


def tree(root: Path) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_trees_equal(a: Path, b: Path, arrays: tuple = ()):
    """Same files; byte-identical, or for names ending in ``arrays`` equal
    as decoded images."""
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        if name.endswith(arrays):
            np.testing.assert_array_equal(png.read_image(b / name),
                                          np.asarray(Image.open(a / name)),
                                          err_msg=name)
        else:
            assert ta[name] == tb[name], name


def records(n=40, gap_at=None):
    out = [{"ImageId": f"IMG{i:04d}", "RecordedAt": i,
            "X": 1000.0 + 2.0 * i + (300.0 if gap_at and i >= gap_at
                                     else 0.0),
            "Y": 500.0 + math.sin(i / 5.0), "Height": 2.0,
            "Yaw": 10.0 + 37.0 * i, "VehicleDirection": 5.0}
           for i in range(n)]
    return {"RecordingProperties": out}


@pytest.mark.parametrize("eval_mode", [True, False])
def test_calibration_matches_jax(tmp_path, eval_mode):
    blob = records(40)
    a = jcal.generate_colmap_from_calibration(
        blob, tmp_path / "j", cube_face_size=512, eval_mode=eval_mode, seed=3)
    b = tcal.generate_colmap_from_calibration(
        blob, tmp_path / "t", cube_face_size=512, eval_mode=eval_mode, seed=3)
    assert a == b
    assert_trees_equal(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("directions,n_interp", [("1", 1), ("2", 2),
                                                 ("3", 1), ("4", 3)])
def test_virtual_cams_match_jax(tmp_path, directions, n_interp):
    """Virtual depth views (a gap between drive passes not bridged) and the
    augmented recording JSON, file for file."""
    blob = records(12, gap_at=6)
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "translation.json").write_text(json.dumps(
            {"x_translation": 1000.0, "y_translation": 500.0}))
    a = jvirtual.augment_recording_details(blob, tmp_path / "j", None,
                                           directions, n_interp)
    b = tvirtual.augment_recording_details(blob, tmp_path / "t", None,
                                           directions, n_interp)
    assert a == b and a["n_virtual_recordings"] == 10 * n_interp
    assert_trees_equal(tmp_path / "j", tmp_path / "t")
    wrap = [{"ImageId": "a", "RecordedAt": 0, "X": 0.0, "Y": 0.0,
             "Yaw": 350.0, "VehicleDirection": 0.0},
            {"ImageId": "b", "RecordedAt": 1, "X": 1.0, "Y": 0.0,
             "Yaw": 10.0, "VehicleDirection": 0.0}]
    assert tvirtual.interpolate_recordings(wrap, 3) == \
        jvirtual.interpolate_recordings(wrap, 3)


def test_reorient_and_simplify_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    tilt = treorient.rotation_to_z_up(np.array([0.3, 0.0, 0.954]))
    np.testing.assert_array_equal(
        tilt, jreorient.rotation_to_z_up(np.array([0.3, 0.0, 0.954])))
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 64, 48,
                                   np.array([60.0, 60, 32, 24]))}
    n_pts = 200
    pts = colmap.ColmapPoints(
        rng.uniform([-5, -5, 0], [5, 5, 0.1], (n_pts, 3)) @ tilt,
        np.zeros((n_pts, 3), np.uint8), np.zeros(n_pts),
        np.arange(n_pts, dtype=np.int64))
    pts.xyz[0] = [1e5, 1e5, 1e5]
    images = {}
    for i in range(12):
        center = np.array([math.cos(i), math.sin(i), 1.0 + 0.01 * i]) @ tilt
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(np.eye(3)), -center, 1, f"i{i}.png",
            rng.uniform(0, 64, (20, 2)),
            rng.integers(0, n_pts, 20).astype(np.int64))
    images[99] = colmap.ColmapImage(99, np.array([1.0, 0, 0, 0]),
                                    np.zeros(3), 1, "empty.png",
                                    np.zeros((0, 2)), np.zeros(0, np.int64))
    colmap.write_model(cams, images, pts, tmp_path / "in")
    for mod, d in ((jreorient, "j"), (treorient, "t")):
        rot, up = mod.auto_reorient(tmp_path / "in", tmp_path / d / "r",
                                    target_med_dist=20.0)
        counts = mod.simplify_images(tmp_path / d / "r", tmp_path / d / "s")
        (tmp_path / d / "out.json").write_text(json.dumps(
            [np.asarray(rot).tolist(), float(up), list(counts)]))
    assert_trees_equal(tmp_path / "j", tmp_path / "t")


def test_matchers_match_jax(tmp_path):
    positions = {f"cam1/{i:04d}.png": np.array([float(i), 0.5 * i])
                 for i in range(30)}
    cams, images, pts = grid_model(n_cams=6, spread=10.0)
    colmap.write_model(cams, images, pts, tmp_path / "s")
    for mod, d in ((jmatch, "j"), (tmatch, "t")):
        (tmp_path / d).mkdir()
        p = mod.make_matcher_pairs(positions, tmp_path / d / "pairs.txt",
                                   n_seq=2, n_quad=3, n_gps=3)
        q = mod.make_distance_pairs(tmp_path / "s", tmp_path / d / "d.txt",
                                    n_neighbors=2)
        (tmp_path / d / "r.json").write_text(json.dumps([p, q]))
    assert_trees_equal(tmp_path / "j", tmp_path / "t")


def test_colmap_db_matches_jax(tmp_path):
    cams, images, _ = grid_model(n_cams=5)
    rows = {}
    for mod, d in ((jdb, "j"), (tdb, "t")):
        db = tmp_path / f"{d}.db"
        mod.fill_database(db, cams, images)
        conn = sqlite3.connect(db)
        rows[d] = {t: conn.execute(f"SELECT * FROM {t}").fetchall()
                   for t in ("cameras", "images")}
        conn.close()
        rows[d]["names"] = mod.read_database_images(db)
    assert rows["t"] == rows["j"]
    assert rows["t"]["names"][1] == "img000.png"


def test_inputs_match_jax(tmp_path):
    """create_inputs, reduce_camera_folders, copy_file_to_chunks, and
    black_mask on a PNG view (arrays equal to JAX's) and a JPEG view (the
    port's quality-95 re-encode at least JAX's PSNR less 0.5 dB against
    the blackened view, the dilated mask the same)."""
    raw = tmp_path / "raw"
    raw.mkdir()
    for img in ("A_f1", "A_r1", "B_f1", "B_u1", "C_l2"):
        (raw / f"{img}.jpg").write_bytes(img.encode())
    rng = np.random.default_rng(0)
    view = rng.integers(0, 255, (32, 40, 3)).astype(np.uint8)
    mask = np.zeros((32, 40), np.uint8)
    mask[10:20, 12:25] = 255
    small = np.zeros((16, 20), np.uint8)       # another size: resized
    small[5:10, 6:12] = 255
    outs = {}
    for mod, d in ((jinputs, "j"), (tinputs, "t")):
        root = tmp_path / d
        n = mod.create_inputs(raw, root / "inputs")
        kept = mod.reduce_camera_folders(root / "inputs" / "images")
        for c in ("0_0", "1_0"):
            (root / "chunks" / c / "sparse" / "0").mkdir(parents=True)
        (root / "test.txt").write_text("x")
        copied = mod.copy_file_to_chunks(root / "test.txt", root / "chunks")
        rect = root / "camera_calibration" / "rectified"
        (rect / "images" / "cam1").mkdir(parents=True)
        (rect / "masks" / "cam1").mkdir(parents=True)
        Image.fromarray(view).save(rect / "images" / "cam1" / "a.png")
        Image.fromarray(view).save(rect / "images" / "cam1" / "b.jpg",
                                   quality=95)
        Image.fromarray(mask).save(rect / "masks" / "cam1" / "a.png")
        Image.fromarray(small).save(rect / "masks" / "cam1" / "b.png")
        outs[d] = (n, kept, copied, mod.black_mask(root))
    assert outs["t"] == outs["j"]
    assert_trees_equal(tmp_path / "j" / "inputs", tmp_path / "t" / "inputs")
    assert_trees_equal(tmp_path / "j" / "chunks", tmp_path / "t" / "chunks")
    rel = "camera_calibration/rectified/images/cam1/"
    np.testing.assert_array_equal(
        png.read_image(tmp_path / "t" / rel / "a.png"),
        np.asarray(Image.open(tmp_path / "j" / rel / "a.png")))
    want = np.asarray(Image.open(tmp_path / "j" / rel / "b.jpg"))
    got = png.read_image(tmp_path / "t" / rel / "b.jpg")
    black_j, black_t = (want.max(axis=2) < 8), (got.max(axis=2) < 8)
    assert (black_j != black_t).mean() < 0.01

    def psnr(x):
        return 10 * np.log10(255.0 ** 2 / np.mean(
            (x.astype(float) - np.where(black_j[..., None], 0, view)) ** 2))
    assert psnr(got) >= psnr(want) - 0.5


def encoded_depth(mm: np.ndarray) -> np.ndarray:
    """Depth in millimetres -> the renderer's B, G, R bytes."""
    units = mm.astype(np.int64)
    prec = np.zeros_like(units)
    for _ in range(4):
        big = units >= (1 << 14)
        units = np.where(big, units >> 2, units)
        prec = np.where(big, prec + 2, prec)
    r = ((prec >> 1) << 6) | (units >> 8)
    return np.stack([(mm > 0).astype(np.int64), units & 255, r],
                    -1).astype(np.uint8)


def test_depth_decode_matches_jax(tmp_path):
    """Encoded depth images (PNG, one JPEG grey, one 8-bit grey) ->
    16-bit inverse-depth PNGs equal as arrays and the params JSON byte for
    byte."""
    rng = np.random.default_rng(1)
    src = tmp_path / "enc"
    src.mkdir()
    for i in range(3):
        mm = rng.integers(500, 900_000, (24, 32))
        mm[:4] = 0
        Image.fromarray(encoded_depth(mm)[..., ::-1]).save(src / f"v{i}.png")
    Image.fromarray(rng.integers(0, 255, (24, 32)).astype(np.uint8)).save(
        src / "grey.png")
    Image.fromarray(rng.integers(0, 255, (24, 32)).astype(np.uint8)).save(
        src / "grey.jpg")
    a = jdecode.convert_depth_dir(src, tmp_path / "j" / "out",
                                  tmp_path / "j" / "p.json")
    b = tdecode.convert_depth_dir(src, tmp_path / "t" / "out",
                                  tmp_path / "t" / "p.json")
    assert a == b
    assert_trees_equal(tmp_path / "j", tmp_path / "t", arrays=(".png",))


def test_depth_scale_matches_jax(tmp_path):
    """``make_depth_scale`` over a model whose views have 16-bit mono maps
    (at half size) gives the same JSON, byte for byte, and the chunk
    driver writes the same files."""
    cams, images, pts = grid_model(n_cams=8, n_pts=400, spread=40.0)
    rng = np.random.default_rng(2)
    for d in ("j", "t"):
        colmap.write_model(cams, images, pts,
                           tmp_path / d / "chunks" / "0_0" / "sparse" / "0")
    depths = tmp_path / "depths"
    depths.mkdir()
    for im in images.values():
        Image.fromarray(rng.integers(0, 65535, (24, 32)).astype(
            np.uint16)).save(depths / (im.name.rsplit(".", 1)[0] + ".png"))
    for mod, d in ((jscale, "j"), (tscale, "t")):
        mod.make_chunks_depth_scale(tmp_path / d / "chunks", depths)
    assert_trees_equal(tmp_path / "j", tmp_path / "t")
    got = json.loads((tmp_path / "t" / "chunks" / "0_0" / "sparse" / "0"
                      / "depth_params.json").read_text())
    assert len(got) == 8 and any(v["scale"] != 0 for v in got.values())


@pytest.mark.parametrize("lidar", [False, True])
def test_chunks_match_jax(tmp_path, lidar):
    """``make_chunks`` (depth-only views with the temporal gap fill, and
    with the LiDAR merge from a LAZ and an npz tile), file for file."""
    cams, images, pts = grid_model(n_cams=10, n_pts=400, spread=90.0)
    sparse = tmp_path / "sparse" / "0"
    colmap.write_model(cams, images, pts, sparse)
    colmap.write_images_binary({
        100 + i: colmap.ColmapImage(
            100 + i, colmap.rotmat2qvec(np.eye(3)),
            -np.array([9.0 * i, 0.5, 1.5]), 1, f"d{i:03d}.png",
            np.zeros((0, 2)), np.zeros(0, np.int64)) for i in range(11)},
        sparse / "images_depths.bin")
    lidar_dir = None
    if lidar:
        from street_sparse_3dgs_tpu_torch.preprocess import laz

        lidar_dir = tmp_path / "lidar"
        lidar_dir.mkdir()
        rng = np.random.default_rng(1)
        laz.write_points(lidar_dir / "a.laz",
                         rng.uniform([0, -5, 0], [45, 5, 3], (4000, 3)),
                         rgb=rng.integers(0, 255, (4000, 3)).astype(
                             np.uint8))
        np.savez(lidar_dir / "b.npz",
                 xyz=rng.uniform([40, -5, 0], [90, 5, 3], (3000, 3)).astype(
                     np.float32),
                 rgb=rng.uniform(0, 1, (3000, 3)).astype(np.float32))
    cfg = dict(chunk_size=40.0, min_n_cams=2, lidar_initialisation=lidar,
               lidar_downsample_density=20.0)
    a = jchunk.make_chunks(sparse, tmp_path / "j", jchunk.ChunkConfig(**cfg),
                           lidar_dir=lidar_dir)
    b = tchunk.make_chunks(sparse, tmp_path / "t", tchunk.ChunkConfig(**cfg),
                           lidar_dir=lidar_dir)
    assert a == b and len(a) >= 2
    assert_trees_equal(tmp_path / "j", tmp_path / "t")
    if lidar:
        _, _, cpts = colmap.read_model(tmp_path / "t" / a[0] / "sparse" / "0")
        assert cpts.ids.max() > pts.ids.max()


def dry_run_logs(tmp_path, monkeypatch, calibration: str):
    """Both packages' ``generate_colmap_project`` logs (``DRY_RUN``, no
    colmap), each in its own project, paths relative to it."""
    logs = {}
    for mod, d in ((jrunner, "j"), (trunner, "t")):
        monkeypatch.setattr(mod, "DRY_RUN", True)
        root = tmp_path / d
        images = root / "inputs" / "images"
        (images / "cam0").mkdir(parents=True)
        (root / "inputs" / "masks").mkdir(parents=True)
        for i in range(4):
            Image.fromarray(np.full((8, 8, 3), i * 40, np.uint8)).save(
                images / "cam0" / f"im{i}.png")
        if calibration == "cal_sfm":
            colmap.write_model(*grid_model(n_cams=6), root / "camera_"
                               "calibration" / "unrectified" / "sparse" / "0")
        log = mod.generate_colmap_project(root, calibration=calibration)
        logs[d] = [line.replace(str(root), "<root>") for line in log]
    return logs


@pytest.mark.parametrize("calibration", ["sfm", "cal_sfm"])
def test_colmap_runner_sequences_match_jax(tmp_path, monkeypatch,
                                           calibration):
    """The sfm and cal_sfm drivers with ``colmap`` absent (dry run): the
    same command sequence as JAX's, and the same files (matcher pairs, the
    database, the masks model)."""
    logs = dry_run_logs(tmp_path, monkeypatch, calibration)
    assert logs["t"] == logs["j"]
    joined = "\n".join(logs["t"])
    steps = (("feature_extractor", "matches_importer", "hierarchical_mapper",
              "image_undistorter", "auto_reorient") if calibration == "sfm"
             else ("feature_extractor", "matches_importer",
                   "point_triangulator", "bundle_adjuster",
                   "image_undistorter"))
    order = [joined.index(s) for s in steps]
    assert order == sorted(order)
    ja = tree(tmp_path / "j" / "camera_calibration")
    ta = tree(tmp_path / "t" / "camera_calibration")
    assert sorted(ja) == sorted(ta)
    for name in ja:
        if name.endswith(".db"):
            continue
        assert ja[name] == ta[name], name


def test_colmap_runner_raises_without_colmap(tmp_path, monkeypatch):
    """Without the binary (and not a dry run) the driver raises, listing
    the commands to run elsewhere."""
    monkeypatch.setattr(trunner, "DRY_RUN", False)
    monkeypatch.setattr(trunner.shutil, "which", lambda name: None)
    (tmp_path / "inputs" / "images").mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "inputs" / "images" / "a.png")
    with pytest.raises(RuntimeError, match="colmap feature_extractor"):
        trunner.generate_colmap_project(tmp_path, calibration="sfm")


def test_make_mask_uint8_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "in" / "cam1").mkdir(parents=True)
    for i in range(3):
        rgba = rng.integers(0, 256, (12, 14, 4)).astype(np.uint8)
        rgba[2:9, 3:10, 3] = 255
        Image.fromarray(rgba).save(tmp_path / "in" / "cam1" / f"m{i}.png")
    Image.fromarray(np.full((6, 6), 255, np.uint8)).save(
        tmp_path / "in" / "g.png")
    assert jrunner.make_mask_uint8(tmp_path / "in", tmp_path / "j") == \
        trunner.make_mask_uint8(tmp_path / "in", tmp_path / "t") == 4
    assert_trees_equal(tmp_path / "j", tmp_path / "t", arrays=(".png",))


def test_depth_pipeline_local_steps_match_jax(tmp_path):
    """``generate_depths`` (virtual views, vis2mesh cameras) on a project,
    ``colmap_to_vis2mesh_json`` and ``mesh_to_ctm_tiles``: the same files,
    CTM bytes included."""
    blob = records(10)
    rng = np.random.default_rng(0)
    verts = np.concatenate([rng.uniform(0, 50, (30, 3)),
                            rng.uniform([150, 0, 0], [199, 50, 50], (30, 3)),
                            rng.uniform([0, 120, 0], [60, 190, 9], (40, 3))])
    tris = np.concatenate([rng.integers(0, 30, (20, 3)),
                           30 + rng.integers(0, 30, (20, 3)),
                           60 + rng.integers(0, 40, (25, 3))]).astype(
        np.int32)
    reports = {}
    for cal, pipe, d in ((jcal, jpipe, "j"), (tcal, tpipe, "t")):
        root = tmp_path / d
        aligned = root / "camera_calibration" / "aligned" / "sparse" / "0"
        extras = root / "camera_calibration" / "extras"
        extras.mkdir(parents=True)
        (extras / "recording_details_train.json").write_text(
            json.dumps(blob))
        cal.generate_colmap_from_calibration(blob, aligned,
                                             cube_face_size=64)
        reports[d] = json.dumps(pipe.generate_depths(
            root, num_interpolations=2), default=str).replace(str(root), "")
        pipe.mesh_to_ctm_tiles(verts, tris, root / "ctm", tile_size=100.0)
    assert reports["t"] == reports["j"]
    assert_trees_equal(tmp_path / "j", tmp_path / "t")
    assert len(list((tmp_path / "t" / "ctm").glob("*.ctm"))) == 3


def test_ctm_native_equals_plain_and_jax(tmp_path):
    """The port's native CTM writer, its plain Python twin and the JAX
    package's writers (native and Python) write the same bytes; the
    reader gives the offset mesh back."""
    import street_sparse_3dgs_tpu.native as jnative

    rng = np.random.default_rng(0)
    verts = rng.uniform(-1, 1, (50, 3)).astype(np.float32) + 100.0
    tris = rng.integers(0, 50, (30, 3)).astype(np.int32)
    off = (100.0, 99.5, 101.0)
    ctm.save_ctm(tmp_path / "native.ctm", verts, tris, off)
    ctm.save_ctm_plain(tmp_path / "plain.ctm", verts, tris, off)
    jnative.save_ctm(tmp_path / "jax.ctm", verts, tris, off)
    jnative._save_ctm_python(tmp_path / "jax_py.ctm", verts, tris,
                             np.asarray(off, np.float64))
    data = (tmp_path / "native.ctm").read_bytes()
    for name in ("plain.ctm", "jax.ctm", "jax_py.ctm"):
        assert (tmp_path / name).read_bytes() == data, name
    v2, t2 = ctm.load_ctm(tmp_path / "native.ctm")
    np.testing.assert_allclose(v2, verts - np.float32(off), atol=1e-5)
    np.testing.assert_array_equal(t2, tris)
    with pytest.raises(ValueError):
        ctm.save_ctm(tmp_path / "x.ctm", verts[:, :2], tris)
