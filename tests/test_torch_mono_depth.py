"""PyTorch port, Depth-Anything (``preprocess/depth_anything.py``) and
``preprocess/mono_depth.py``: the JAX package's ``dav2_forward`` and the
port's module on the same random weights (made with numpy from a seed) at
atol 1e-4 x max|depth| (the JAX test's bar), at a non-square size with the
position grid resampled; both published namings (the original repo's, and
HuggingFace's from the tiny ``transformers`` model the JAX tests build,
behind ``importorskip``); the JAX-pytree converter; the resizes against
``jax.image.resize``; ``infer_inverse_depth`` end to end; and
``generate_depth``'s 16-bit PNG contract against ``generate_depth_jax``'s."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from street_sparse_3dgs_tpu.preprocess import depth_anything_jax as daj
from street_sparse_3dgs_tpu.preprocess import mono_depth as jmono
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.data import png
from street_sparse_3dgs_tpu_torch.preprocess import depth_anything as da
from street_sparse_3dgs_tpu_torch.preprocess import mono_depth as tmono

torch.set_num_threads(1)
CFG = da.DAV2Config(hidden=32, layers=4, heads=2, patch=14,
                    out_indices=(0, 1, 2, 3), neck_sizes=(8, 12, 16, 16),
                    fusion=16, head_hidden=8)
JCFG = daj.DAV2Config(**dataclasses.asdict(CFG))
GRID = 5                     # a 70x70 checkpoint's position grid


def weights(seed=0, cfg=CFG):
    """(port state, original-naming state dict as numpy, JAX params)."""
    state = da.random_state(cfg, GRID, seed)
    orig = {k: v.numpy() for k, v in
            da.to_original_naming(state, cfg).items()}
    params, _ = daj.convert_torch_state(orig, JCFG)
    return state, orig, params


def assert_close(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0.1                  # non-degenerate activations
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("hw", [(70, 70), (98, 56)])
def test_forward_matches_jax(hw):
    """Square at the checkpoint's grid, and non-square (bicubic position
    resampling, the stride-2 reassemble conv on even sizes, every fusion
    upsample)."""
    state, _, params = weights()
    x = np.random.default_rng(1).normal(size=(1, 3) + hw).astype(np.float32)
    want = np.asarray(daj.dav2_forward(params, JCFG, x))
    with torch.no_grad():
        got = da.build_model(state, CFG, "cpu")(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    assert_close(got, want)


def test_original_naming_round_trip_and_config():
    """The original repo's naming converts back to the same state; the
    architecture is recovered from it (heads from the width, as JAX's)."""
    state, orig, _ = weights()
    back, cfg = da.convert_state_dict(orig, CFG)
    assert set(back) == set(state)
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k].numpy(),
                                      err_msg=k)
    inferred = da.infer_config(orig)
    jinferred = daj.infer_config(orig)
    for f in ("hidden", "layers", "patch", "out_indices", "neck_sizes",
              "fusion", "heads"):
        assert getattr(inferred, f) == getattr(jinferred, f), f
    assert inferred.head_hidden == CFG.head_hidden


def test_jax_pytree_converter():
    """``convert.depth_anything_from_numpy`` on JAX's param pytree gives
    the module JAX's weights: its forward equals JAX's."""
    _, _, params = weights(seed=2)
    model = convert.depth_anything_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), JCFG, "cpu")
    x = np.random.default_rng(3).normal(size=(1, 3, 70, 98)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    assert_close(got, np.asarray(daj.dav2_forward(params, JCFG, x)))


def tiny_hf_model(heads=2, seed=42):
    """tests/test_mono_depth_jax.py's tiny ``transformers`` model, its
    weights scaled as the random_state rule (the JAX test's N(0, 0.25)
    everywhere saturates the head's ReLU here)."""
    transformers = pytest.importorskip("transformers")
    bb = transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=heads,
        intermediate_size=64, patch_size=14, image_size=70,
        out_features=["stage1", "stage2", "stage3", "stage4"],
        out_indices=[1, 2, 3, 4], reshape_hidden_states=False)
    cfg = transformers.DepthAnythingConfig(
        backbone_config=bb, fusion_hidden_size=16, reassemble_hidden_size=32,
        neck_hidden_sizes=[8, 12, 16, 16], head_hidden_size=8, patch_size=14,
        reassemble_factors=[4, 2, 1, 0.5])
    m = transformers.DepthAnythingForDepthEstimation(cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if k.endswith("weight") and v.dim() >= 2:
                v.copy_(torch.randn(v.shape, generator=g)
                        / v[0].numel() ** 0.5)
            elif "norm" in k and k.endswith("weight"):
                v.copy_(1 + 0.1 * torch.randn(v.shape, generator=g))
            else:
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
        m.head.conv3.bias.fill_(0.5)
    return m


def test_hf_naming_matches_transformers_and_jax():
    """The HuggingFace naming (the tiny ``transformers`` model's state
    dict): the port equals ``transformers``' forward and JAX's at a
    non-square size."""
    m = tiny_hf_model()
    x = torch.randn(1, 3, 70, 84, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = m(pixel_values=x).predicted_depth.numpy()
    state, _ = da.convert_state_dict(m.state_dict(), CFG)
    with torch.no_grad():
        got = da.build_model(state, CFG, "cpu")(x).numpy()
    assert_close(got, ref)
    params, _ = daj.convert_torch_state(m.state_dict(), JCFG)
    assert_close(got, np.asarray(daj.dav2_forward(params, JCFG, x.numpy())))


def test_both_namings_agree():
    """The HF naming of the tiny model and the original naming built from
    it (as JAX's converter test builds it) give the same depth."""
    m = tiny_hf_model()
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    hf_state, _ = da.convert_state_dict(sd, CFG)
    orig = da.to_original_naming(hf_state, CFG)
    or_state, _ = da.convert_state_dict(orig, CFG)
    for k in hf_state:
        np.testing.assert_array_equal(or_state[k].numpy(),
                                      hf_state[k].numpy(), err_msg=k)


@pytest.mark.parametrize("shape", [(37, 7), (518, 2048), (2048, 518),
                                   (70, 70), (5, 40)])
def test_linear_resize_matches_jax(shape):
    """``resize_bilinear_jax`` = ``jax.image.resize(..., "bilinear")``:
    antialiased and renormalised at the borders when downsampling."""
    n_in, n_out = shape
    x = np.random.default_rng(0).normal(size=(2, n_in, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, 3),
                                       "bilinear"))
    got = da.resize_bilinear_jax(torch.tensor(x).permute(0, 2, 1),
                                 (3, n_out)).permute(0, 2, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bicubic_pos_resample_is_torch_bicubic():
    """JAX's ``_resize_bicubic_torch`` (A = -0.75, half-pixel centres,
    replicated borders) equals ``F.interpolate(mode="bicubic")``, which
    the port uses."""
    g = np.random.default_rng(4).normal(size=(1, 5, 5, 8)).astype(np.float32)
    for out in ((6, 7), (3, 9), (10, 10)):
        want = np.asarray(daj._resize_bicubic_torch(jnp.asarray(g), out))
        got = F.interpolate(torch.tensor(g).permute(0, 3, 1, 2), size=out,
                            mode="bicubic", align_corners=False
                            ).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw,target", [((61, 97), 42), ((300, 200), 56)])
def test_infer_inverse_depth_matches_jax(hw, target):
    """The DA-V2 transform (uint8 -> /255, resize to multiples of 14 around
    ``target``, ImageNet normalisation), the forward and the resize back."""
    state, _, params = weights(seed=5)
    img = np.random.default_rng(6).integers(0, 255, hw + (3,)).astype(
        np.uint8)
    xj, _ = daj.preprocess_image(img, target)
    xt, size = da.preprocess_image(img, target, "cpu")
    assert size == hw and tuple(xt.shape) == tuple(xj.shape)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-5)
    want = daj.infer_inverse_depth(params, JCFG, img, target=target)
    got = da.infer_inverse_depth(da.build_model(state, CFG, "cpu"), img,
                                 target=target)
    assert got.shape == hw
    assert_close(got.numpy(), want)


def test_checkpoint_loads_from_disk(tmp_path):
    """``load_checkpoint`` reads a ``.pth`` (a ``state_dict`` wrapper too)
    and a converted ``.npz``, to the device asked for."""
    state, orig, _ = weights(seed=7)
    torch.save({k: torch.tensor(v) for k, v in orig.items()},
               tmp_path / "a.pth")
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in orig.items()}},
               tmp_path / "b.pth")
    np.savez(tmp_path / "c.npz", **orig)
    x = torch.tensor(np.random.default_rng(8).normal(
        size=(1, 3, 70, 70)).astype(np.float32))
    with torch.no_grad():
        want = da.build_model(state, CFG, "cpu")(x).numpy()
        for name in ("a.pth", "b.pth", "c.npz"):
            model, cfg = da.load_checkpoint(tmp_path / name, "cpu")
            assert cfg.hidden == CFG.hidden and cfg.layers == CFG.layers
            assert next(model.parameters()).device.type == "cpu"
            got = model(x).numpy()
            assert got.shape == want.shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            da.load_checkpoint(tmp_path / "a.pth")


def test_generate_depth_png_contract_matches_jax(tmp_path, monkeypatch):
    """A checkpoint file (original naming) -> ``generate_depth`` on the CPU
    -> 16-bit inverse-depth PNGs mirroring the image tree, each per-image
    normalised to the full range and within 2e-3 x 65535 of
    ``generate_depth_jax``'s on the same file."""
    cfg = dataclasses.replace(CFG, heads=1)      # infer_config's heads
    state = da.random_state(cfg, GRID, 9)
    ckpt = tmp_path / "tiny.pth"
    torch.save(da.to_original_naming(state, cfg), ckpt)
    images = tmp_path / "images" / "cam0"
    images.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for name in ("a.png", "b.jpg"):
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8),
                        "RGB").save(images / name)
    monkeypatch.setenv("DEPTH_ANYTHING_CKPT", str(ckpt))
    monkeypatch.setenv("DEPTH_ANYTHING_TARGET", "42")
    assert tmono.generate_depth(tmp_path / "images", tmp_path / "t",
                                device="cpu") == 2
    assert jmono.generate_depth(tmp_path / "images", tmp_path / "j") == 2
    for name in ("a.png", "b.png"):
        got = png.read_image(tmp_path / "t" / "cam0" / name)
        want = np.asarray(Image.open(tmp_path / "j" / "cam0" / name))
        assert got.dtype == np.uint16 and got.shape == (40, 52)
        assert got.max() == 65535 and got.min() == 0
        assert np.abs(got.astype(np.int64) - want).max() <= 2e-3 * 65535


def test_generate_depth_external_branches(tmp_path, monkeypatch):
    """With a Depth-Anything checkout it shells out exactly as JAX's; with
    neither a checkpoint nor a checkout nor ``transformers`` weights it
    raises naming the command to run elsewhere."""
    assert tmono.depth_anything_cli_cmd("imgs", "out", encoder="vits") == \
        jmono.depth_anything_cli_cmd("imgs", "out", encoder="vits")
    da_dir = tmp_path / "da"
    da_dir.mkdir()
    (da_dir / "run.py").write_text("")
    monkeypatch.setenv("DEPTH_ANYTHING_DIR", str(da_dir))
    monkeypatch.delenv("DEPTH_ANYTHING_CKPT", raising=False)
    calls = {}
    monkeypatch.setattr(tmono.subprocess, "run",
                        lambda c, check: calls.setdefault("cmd", c))
    tmono.generate_depth(tmp_path / "imgs", tmp_path / "out", device="cpu")
    assert calls["cmd"] == tmono.depth_anything_cli_cmd(
        tmp_path / "imgs", tmp_path / "out")
    monkeypatch.setenv("DEPTH_ANYTHING_DIR", str(tmp_path / "none"))
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(RuntimeError, match="run.py"):
        tmono.generate_depth(tmp_path / "imgs", tmp_path / "out2",
                             device="cpu")
    arr = np.linspace(0.0, 4.0, 64).reshape(8, 8).astype(np.float32)
    np.testing.assert_array_equal(tmono.to_16bit(arr),
                                  (((arr - 0.0) / 4.0) * 65535.0).astype(
                                      np.uint16))
    assert os.environ.get("DEPTH_ANYTHING_CKPT") is None


def test_generate_depth_needs_the_card_by_default(tmp_path, monkeypatch):
    """With a checkpoint named and no ``device``, ``generate_depth`` runs
    on the card: it raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    state = da.random_state(dataclasses.replace(CFG, heads=1), GRID, 10)
    torch.save(da.to_original_naming(state, CFG), tmp_path / "c.pth")
    (tmp_path / "images").mkdir()
    monkeypatch.setenv("DEPTH_ANYTHING_CKPT", str(tmp_path / "c.pth"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmono.generate_depth(tmp_path / "images", tmp_path / "out")


class _FakeTransformers:
    """A stand-in for ``transformers`` that records what the
    ``transformers`` branch of ``generate_depth`` asks of it."""

    def __init__(self):
        self.calls = []
        fake = self

        class Batch(dict):
            def to(self, dev):
                fake.calls.append(("inputs.to", torch.device(dev)))
                return self

        class Processor:
            def __call__(self, images, return_tensors):
                assert images.dtype == np.uint8 and images.shape[2] == 3
                return Batch(pixel_values=torch.from_numpy(
                    images.astype(np.float32)).permute(2, 0, 1)[None])

            def post_process_depth_estimation(self, out, target_sizes):
                (h, w), = target_sizes
                return [{"predicted_depth": out[:, :h, :w][0]}]

        class Model:
            def to(self, dev):
                fake.calls.append(("model.to", torch.device(dev)))
                return self

            def eval(self):
                return self

            def __call__(self, pixel_values):
                return pixel_values.mean(1)

        def loader(made):
            def from_pretrained(name, **kw):
                fake.calls.append(("from_pretrained", name, kw))
                return made()
            return type("Auto", (), {"from_pretrained":
                                     staticmethod(from_pretrained)})

        self.AutoImageProcessor = loader(Processor)
        self.AutoModelForDepthEstimation = loader(Model)


def test_generate_depth_transformers_branch_keeps_the_device(tmp_path,
                                                             monkeypatch):
    """The ``transformers`` branch loads local files only, runs on the
    device asked for (never the CPU in place of a requested card), and
    writes the 16-bit PNG contract without PIL."""
    import sys

    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    png.write_png(tmp_path / "imgs" / "a.png",
                  rng.integers(0, 256, (12, 10, 3), dtype=np.uint8))
    monkeypatch.delenv("DEPTH_ANYTHING_CKPT", raising=False)
    monkeypatch.setenv("DEPTH_ANYTHING_DIR", str(tmp_path / "none"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    fake = _FakeTransformers()
    monkeypatch.setitem(sys.modules, "transformers", fake)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmono.generate_depth(tmp_path / "imgs", tmp_path / "out")
        assert fake.calls == []          # raised before loading anything
    assert tmono.generate_depth(tmp_path / "imgs", tmp_path / "out",
                                encoder="vits", device="cpu") == 1
    loads = [c for c in fake.calls if c[0] == "from_pretrained"]
    assert len(loads) == 2
    for _, name, kw in loads:
        assert name == "depth-anything/Depth-Anything-V2-Small-hf"
        assert kw == {"local_files_only": True}
    moves = [c[1] for c in fake.calls if c[0] != "from_pretrained"]
    assert moves and all(d == torch.device("cpu") for d in moves)
    got = png.read_image(tmp_path / "out" / "a.png")
    assert got.dtype == np.uint16 and got.shape == (12, 10)
    assert got.min() == 0 and got.max() == 65535
