"""PyTorch port, forward blend kernels: the plain versions of K1
(``blend_padded``) and K3 (``blend_exact``) against the JAX Pallas kernels
``_blend_packed`` / ``_blend_exact`` in interpret mode, on the same numpy
inputs.  On CPU tensors the port's wrappers run exactly these plain
versions; ``chip_smoke.py`` holds the CUDA kernels against them on the card.

Rows R, G, B, invdepth, alpha and log T agree to 2e-5 (the forward bar of
tests/test_pallas_blend.py).  Row n_contrib is compared as
min(nc_jax, count): the TPU kernel also counts the padding lanes of its
last live 128-block."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from street_sparse_3dgs_tpu.ops import pallas_blend as jpb
from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb

torch.set_num_threads(1)
ATOL = 2e-5
TILES_X, TILES_Y = 4, 3


def random_slots(rng, n, terminate):
    """[n, 10] slot rows (mx my ca cb cc r g b op invd) over a 64x48 frame.
    With ``terminate`` the first 100 slots are wide and nearly opaque (every
    pixel terminates among them) and the rest is faint bait that must not
    bring a terminated pixel back."""
    s = np.zeros((n, 10), np.float32)
    s[:, 0] = rng.uniform(-8, 72, n)
    s[:, 1] = rng.uniform(-8, 56, n)
    sig = rng.uniform(1.5, 6.0, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    s[:, 2] = 1.0 / (sig[:, 0] ** 2 * (1 - rho ** 2))
    s[:, 3] = -rho / (sig[:, 0] * sig[:, 1] * (1 - rho ** 2))
    s[:, 4] = 1.0 / (sig[:, 1] ** 2 * (1 - rho ** 2))
    s[:, 5:8] = rng.uniform(0, 1, (n, 3))
    s[:, 8] = rng.uniform(0.05, 0.9, n)
    s[:, 9] = rng.uniform(0.1, 0.5, n)
    if terminate:
        front = np.arange(n) < 100
        s[front, 2] = s[front, 4] = 1.0 / 30.0 ** 2
        s[front, 3] = 0.0
        s[front, 8] = rng.uniform(0.9, 0.99, front.sum())
        s[~front, 8] = rng.uniform(0.006, 0.012, (~front).sum())
    return s


def compare(got: torch.Tensor, want, counts_live):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_allclose(got[:, :6], want[:, :6], rtol=0, atol=ATOL)
    nc_want = np.minimum(want[:, 6], counts_live[:, None])
    np.testing.assert_array_equal(got[:, 6], nc_want)


K1_CASES = {
    "benign": dict(terminate=False, tile0=0, t_mod=0, per_tile_bg=False),
    "terminate_across_blocks": dict(terminate=True, tile0=0, t_mod=0,
                                    per_tile_bg=False),
    "tile0_per_tile_bg": dict(terminate=False, tile0=5, t_mod=12,
                              per_tile_bg=True),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_jax_blend_packed(case):
    c = K1_CASES[case]
    rng = np.random.default_rng(11)
    t, k = TILES_X * TILES_Y, 256
    counts = rng.integers(0, 320, t).astype(np.int32)
    counts[0], counts[1] = 0, k                    # empty and exactly full
    if c["terminate"]:
        counts[:] = np.maximum(counts, 200)
    attrs = np.ascontiguousarray(np.stack([
        random_slots(rng, k, c["terminate"]).T for _ in range(t)]))
    bg = (rng.uniform(0, 1, (t, 3)) if c["per_tile_bg"]
          else np.array([[0.2, 0.4, 0.6]])).astype(np.float32)
    want = jpb._blend_packed(
        True, TILES_X, c["t_mod"], 1, jnp.full((1, 1), c["tile0"], jnp.int32),
        jnp.asarray(counts)[None, :], jnp.asarray(attrs), jnp.asarray(bg))
    got = cb.blend_padded(torch.tensor(attrs), torch.tensor(counts),
                          torch.tensor(bg), TILES_X, c["tile0"], c["t_mod"])
    compare(got, want, np.minimum(counts, k))
    if c["terminate"]:
        # Every pixel of a full tile terminated inside the opaque front.
        live = counts >= 200
        assert (got[live, 6].numpy() < 200).all()
        assert (got[live, 5].numpy() > np.log(1e-4) - 5).all()


def exact_layout(tile_counts, k, extra_unused):
    """vcounts, wt, last_v, t_of_v of a virtual-tile layout: tile t owns
    ceil(count / K) consecutive windows (at least one), then
    ``extra_unused`` budget windows no tile uses."""
    vcounts, wt, t_of_v, last_v = [], [], [], []
    for ti, cnt in enumerate(tile_counts):
        nw = max(1, -(-cnt // k))
        for j in range(nw):
            vcounts.append(int(np.clip(cnt - j * k, 0, k)))
            wt.append(j)
            t_of_v.append(ti)
        last_v.append(len(vcounts) - 1)
    t = len(tile_counts)
    vcounts += [0] * extra_unused
    wt += [0] * extra_unused
    t_of_v += [t] * extra_unused
    return (np.array(vcounts, np.int32), np.array(wt, np.int32),
            np.array(last_v, np.int32), np.array(t_of_v, np.int32))


K3_CASES = {"benign": False, "terminate_across_windows": True}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_plain_matches_jax_blend_exact(case):
    terminate = K3_CASES[case]
    rng = np.random.default_rng(5)
    k = 128
    tile_counts = [0, 300, 128, 129, 40, 512, 7, 256, 1, 384, 200, 90]
    if terminate:
        tile_counts = [max(c, 300) for c in tile_counts]
    vcounts, wt, last_v, t_of_v = exact_layout(tile_counts, k, 5)
    nv, t = vcounts.shape[0], len(tile_counts)
    attrs = np.zeros((nv, k, 10), np.float32)
    for ti, cnt in enumerate(tile_counts):
        slots = random_slots(rng, max(cnt, 1), terminate)
        first = last_v[ti] - wt[last_v[ti]]
        for j in range(wt[last_v[ti]] + 1):
            part = slots[j * k:(j + 1) * k]
            attrs[first + j, :len(part)] = part
    attrs[t_of_v == t] = rng.uniform(0, 1, attrs[t_of_v == t].shape)
    bg = np.array([[0.3, 0.2, 0.1]], np.float32)

    t_safe = np.minimum(t_of_v, t - 1)
    is_last = (t_of_v >= t) | (np.arange(nv) == last_v[t_safe])
    meta = np.stack([t_safe, wt, vcounts, is_last.astype(np.int32)])
    want = jpb._blend_exact(True, TILES_X, 1, None, None, 0,
                            jnp.asarray(meta), jnp.asarray(last_v),
                            jnp.asarray(attrs), jnp.asarray(bg))
    got = cb.blend_exact(torch.tensor(attrs), torch.tensor(vcounts),
                         torch.tensor(wt), torch.tensor(last_v),
                         torch.tensor(bg), TILES_X)
    compare(got, want, np.array(tile_counts))
    if terminate:
        # Termination persists across windows: no pixel walks past slot 300.
        assert (got[:, 6].numpy() < 300).all()


def test_blend_backward_names_training_slice():
    """The blend wrappers are differentiable (K2 / K4 on the card, their
    plain versions here): with no live slot every pixel shows the
    background, so the attrs get zero grads and bg gets the pixel count."""
    attrs = torch.zeros(1, 10, 128, requires_grad=True)
    bg = torch.zeros(1, 3, requires_grad=True)
    out = cb.blend_padded(attrs, torch.zeros(1, dtype=torch.int32), bg, 1)
    out[:, :3].sum().backward()
    assert torch.equal(attrs.grad, torch.zeros_like(attrs))
    assert torch.equal(bg.grad, torch.full((1, 3), 256.0))
    pairs = torch.zeros(1, 128, 10, requires_grad=True)
    bg = torch.zeros(1, 3, requires_grad=True)
    out = cb.blend_exact(pairs, torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), bg, 1)
    out[:, :3].sum().backward()
    assert torch.equal(pairs.grad, torch.zeros_like(pairs))
    assert torch.equal(bg.grad, torch.full((1, 3), 256.0))


def test_blend_wrappers_check_inputs():
    with pytest.raises(ValueError, match="counts"):
        cb.blend_padded(torch.zeros(2, 10, 128), torch.zeros(2),
                        torch.zeros(1, 3), 1)
    with pytest.raises(ValueError, match="inconsistent"):
        cb.blend_padded(torch.zeros(2, 10, 128),
                        torch.zeros(3, dtype=torch.int32), torch.zeros(1, 3),
                        1)
    with pytest.raises(ValueError, match="inconsistent"):
        z = torch.zeros(2, dtype=torch.int32)
        cb.blend_exact(torch.zeros(2, 128, 10), z, z, z, torch.zeros(2, 3), 1)
