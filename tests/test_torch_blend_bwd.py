"""PyTorch port, backward blend kernels: the plain versions of K2
(``blend_padded_bwd``) and K4 (``blend_exact_bwd``, and its launch order
``exact_tile_order``), reached through the
autograd ``backward`` of ``blend_padded`` / ``blend_exact`` on CPU tensors,
against JAX's ``_blend_packed_bwd`` / ``_blend_exact_bwd`` in interpret
mode, fed through ``jax.vjp`` of ``_blend_packed`` / ``_blend_exact`` on the
same numpy inputs and cotangent.  Each package's backward reads its own
forward's saved rows (the TPU kernel's n_contrib also counts padding
lanes, which its backward masks out).

Bar: per channel, 3e-4 * max|g| of that channel with rtol 2e-3 (the
gradient bar of tests/test_pallas_blend.py); the background grad too.
``chip_smoke.py`` holds the CUDA kernels against these plain versions on
the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from street_sparse_3dgs_tpu.ops import pallas_blend as jpb
from street_sparse_3dgs_tpu_torch.ops import binning as tbin
from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
from street_sparse_3dgs_tpu_torch.ops.preprocess import Projected
from test_torch_binning import scene_data
from test_torch_blend import TILES_X, TILES_Y, exact_layout, random_slots

torch.set_num_threads(1)


def close(got, want, what):
    """|got - want| <= 3e-4 * max|want| of the channel + 2e-3 * |want|, the
    channel on the last axis."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=0) + 1e-12
    excess = np.abs(got - want) - 2e-3 * np.abs(want) - 3e-4 * scale
    assert (excess <= 0).all(), (
        what, float((np.abs(got - want) / scale).max()))


def channels_last(x, channel_axis):
    return np.moveaxis(np.asarray(x), channel_axis, -1).reshape(-1, 10)


K2_CASES = {
    "benign": dict(terminate=False, tile0=0, t_mod=0, per_tile_bg=False,
                   clamp=False),
    "terminate_across_blocks": dict(terminate=True, tile0=0, t_mod=0,
                                    per_tile_bg=False, clamp=False),
    "tile0_t_mod": dict(terminate=False, tile0=5, t_mod=12,
                        per_tile_bg=False, clamp=False),
    "per_tile_bg": dict(terminate=False, tile0=0, t_mod=0, per_tile_bg=True,
                        clamp=False),
    "clamped_alpha": dict(terminate=False, tile0=0, t_mod=0,
                          per_tile_bg=False, clamp=True),
}


def clamp_some(rng, slots):
    """Near-opaque narrow slots: their raw alpha reaches 0.99 at the
    centre pixels, where the grad of alpha is cut."""
    pick = rng.uniform(0, 1, slots.shape[0]) < 0.15
    slots[pick, 8] = rng.uniform(0.995, 1.0, pick.sum())
    return slots


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_matches_jax_blend_packed_bwd(case):
    c = K2_CASES[case]
    rng = np.random.default_rng(23)
    t, k = TILES_X * TILES_Y, 256
    counts = rng.integers(0, 320, t).astype(np.int32)
    counts[0], counts[1] = 0, k
    if c["terminate"]:
        counts[:] = np.maximum(counts, 200)
    slots = [random_slots(rng, k, c["terminate"]) for _ in range(t)]
    if c["clamp"]:
        slots = [clamp_some(rng, s) for s in slots]
    attrs = np.ascontiguousarray(np.stack([s.T for s in slots]))
    bg = (rng.uniform(0, 1, (t, 3)) if c["per_tile_bg"]
          else np.array([[0.2, 0.4, 0.6]])).astype(np.float32)
    g_out = rng.normal(0, 1, (t, 8, 256)).astype(np.float32)

    tile0 = jnp.full((1, 1), c["tile0"], jnp.int32)
    _, vjp = jax.vjp(lambda a, b: jpb._blend_packed(
        True, TILES_X, c["t_mod"], 1, tile0, jnp.asarray(counts)[None, :],
        a, b), jnp.asarray(attrs), jnp.asarray(bg))
    want_a, want_bg = vjp(jnp.asarray(g_out))

    a_t = torch.tensor(attrs, requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    out = cb.blend_padded(a_t, torch.tensor(counts), bg_t, TILES_X,
                          c["tile0"], c["t_mod"])
    out.backward(torch.tensor(g_out))
    close(channels_last(a_t.grad, 1), channels_last(want_a, 1), "attrs")
    close(bg_t.grad.numpy(), np.asarray(want_bg), "bg")
    # Slots past each tile's count get exactly zero.
    for ti, cnt in enumerate(counts):
        assert not a_t.grad[ti, :, min(cnt, k):].any()
    if c["clamp"]:
        assert float(np.abs(np.asarray(want_a)[:, 8]).max()) > 0


K4_CASES = {"benign": dict(terminate=False, clamp=False),
            "terminate_across_windows": dict(terminate=True, clamp=False),
            "clamped_alpha": dict(terminate=False, clamp=True)}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_plain_matches_jax_blend_exact_bwd(case):
    """Multi-window tiles (a partial last window, a tile with no pairs) and
    five budget windows no tile uses."""
    c = K4_CASES[case]
    rng = np.random.default_rng(29)
    k = 128
    tile_counts = [0, 300, 128, 129, 40, 512, 7, 256, 1, 384, 200, 90]
    if c["terminate"]:
        tile_counts = [max(n, 300) for n in tile_counts]
    vcounts, wt, last_v, t_of_v = exact_layout(tile_counts, k, 5)
    nv, t = vcounts.shape[0], len(tile_counts)
    attrs = np.zeros((nv, k, 10), np.float32)
    for ti, cnt in enumerate(tile_counts):
        slots = random_slots(rng, max(cnt, 1), c["terminate"])
        if c["clamp"]:
            slots = clamp_some(rng, slots)
        first = last_v[ti] - wt[last_v[ti]]
        for j in range(wt[last_v[ti]] + 1):
            part = slots[j * k:(j + 1) * k]
            attrs[first + j, :len(part)] = part
    attrs[t_of_v == t] = rng.uniform(0, 1, attrs[t_of_v == t].shape)
    bg = np.array([[0.3, 0.2, 0.1]], np.float32)
    g_out = rng.normal(0, 1, (t, 8, 256)).astype(np.float32)

    t_safe = np.minimum(t_of_v, t - 1)
    is_last = (t_of_v >= t) | (np.arange(nv) == last_v[t_safe])
    meta = np.stack([t_safe, wt, vcounts, is_last.astype(np.int32)])
    _, vjp = jax.vjp(lambda a, b: jpb._blend_exact(
        True, TILES_X, 1, None, None, 0, jnp.asarray(meta),
        jnp.asarray(last_v), a, b), jnp.asarray(attrs), jnp.asarray(bg))
    want_a, want_bg = vjp(jnp.asarray(g_out))

    a_t = torch.tensor(attrs, requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    out = cb.blend_exact(a_t, torch.tensor(vcounts), torch.tensor(wt),
                         torch.tensor(last_v), bg_t, TILES_X)
    out.backward(torch.tensor(g_out))
    close(channels_last(a_t.grad, 2), channels_last(want_a, 2), "attrs")
    close(bg_t.grad.numpy(), np.asarray(want_bg), "bg")
    # Budget windows no tile uses stay exactly zero.
    assert not a_t.grad[torch.tensor(t_of_v == t)].any()


def test_k2_plain_finite_differences_f64():
    """The plain backward against central differences of the plain forward,
    both in float64, on a smooth tiny case (no clamped alpha, no
    termination, opacities well inside (1/255, 0.99))."""
    rng = np.random.default_rng(3)
    t, k = 2, 128
    slots = [random_slots(rng, k, False) for _ in range(t)]
    attrs = torch.tensor(np.stack([s.T for s in slots]), dtype=torch.float64)
    attrs[:, 8] = attrs[:, 8].clamp(0.1, 0.6)
    counts = torch.tensor([40, 25], dtype=torch.int32)
    bg = torch.tensor([[0.3, 0.5, 0.7]], dtype=torch.float64)
    g_out = torch.tensor(rng.normal(0, 1, (t, 8, 256)))
    g_out[:, 5:] = 0.0

    def loss(a):
        return float(torch.sum(cb.blend_padded_plain(a, counts, bg, 2)
                               * g_out))

    saved = cb.blend_padded_plain(attrs, counts, bg, 2)
    grad = cb.blend_padded_bwd_plain(attrs, counts, bg, saved, g_out, 2)
    eps = 1e-6
    checked = 0
    for ti in range(t):
        for slot in range(0, int(counts[ti]), 7):
            for ch in range(10):
                up, dn = attrs.clone(), attrs.clone()
                up[ti, ch, slot] += eps
                dn[ti, ch, slot] -= eps
                fd = (loss(up) - loss(dn)) / (2 * eps)
                g = float(grad[ti, ch, slot])
                assert abs(fd - g) <= 1e-5 * max(1.0, abs(fd)), \
                    (ti, ch, slot, fd, g)
                checked += 1
    assert checked >= 90


def toy_exact_layout():
    """A multi-window exact layout: the port's ``bin_gaussians(...,
    exact_extra=64)`` on the JAX toy scene (2048 rows, 128x96, K = 128),
    and the pair-major attrs it packs."""
    data = scene_data(0, 2048, 128, 96)
    proj = Projected(*(torch.tensor(np.asarray(x)) for x in data["proj"]))
    bins = tbin.bin_gaussians(proj, 96, 128, 16, 128, exact_extra=64)
    attrs = cb.pack_gather_attrs(bins.gather, proj.mean2d, proj.conic,
                                 proj.color, proj.opacity, proj.inv_depth,
                                 order=bins.order, rank=bins.rank,
                                 pair_major=True).detach()
    return attrs, bins.vcounts, bins.wt, bins.last_v, bins.tiles_x


def one_tile_layout():
    """One real tile over three windows (300 pairs) and two unused budget
    windows."""
    rng = np.random.default_rng(31)
    vcounts, wt, last_v, _ = exact_layout([300], 128, 2)
    attrs = np.zeros((vcounts.shape[0], 128, 10), np.float32)
    slots = random_slots(rng, 300, False)
    for j in range(3):
        attrs[j, :len(slots[j * 128:(j + 1) * 128])] = slots[j * 128:
                                                             (j + 1) * 128]
    return (torch.tensor(attrs), torch.tensor(vcounts), torch.tensor(wt),
            torch.tensor(last_v), 1)


def no_tile_layout():
    """No real tile: three budget windows no tile uses."""
    return (torch.zeros((3, 128, 10)), torch.zeros(3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32), 1)


ORDER_LAYOUTS = {"no_tile": no_tile_layout, "one_tile": one_tile_layout,
                 "toy_multi_window": toy_exact_layout}


@pytest.mark.parametrize("layout", sorted(ORDER_LAYOUTS))
def test_k4_launch_order(layout):
    """``exact_tile_order`` (K4's launch order) is a permutation of the real
    tiles, deepest first, ties in tile order; and the backward on CPU
    tensors (the plain version) gives the same grads with or without it.
    A bad order is refused."""
    attrs, vcounts, wt, last_v, tiles_x = ORDER_LAYOUTS[layout]()
    t = last_v.shape[0]
    order = cb.exact_tile_order(wt, last_v)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(t))
    windows = (wt.to(torch.int64)[last_v.to(torch.int64)] + 1)[
        order.to(torch.int64)].tolist()
    keys = [(-w, i) for w, i in zip(windows, order.tolist())]
    assert keys == sorted(keys)
    if layout == "toy_multi_window":
        assert max(windows) > 1 and t > 1

    bg = torch.tensor([[0.3, 0.2, 0.1]])
    saved = cb.blend_exact_plain(attrs, vcounts, wt, last_v, bg, tiles_x)
    g_out = torch.tensor(np.random.default_rng(37).normal(
        0, 1, (t, 8, 256)).astype(np.float32))
    args = (attrs, vcounts, wt, last_v, bg, saved, g_out, tiles_x)
    want = cb.blend_exact_bwd(*args)
    assert torch.equal(cb.blend_exact_bwd(*args, order=order), want)
    assert torch.equal(cb.blend_exact_bwd(*args, order=order.flip(0)), want)
    if t:
        assert want.any()
    with pytest.raises(ValueError, match="order"):
        cb.blend_exact_bwd(*args, order=order.to(torch.int64))
    with pytest.raises(ValueError, match="order"):
        cb.blend_exact_bwd(*args, order=torch.zeros(t + 1,
                                                    dtype=torch.int32))


@pytest.mark.parametrize("split", ["first_half", "second_half", "deepest"])
def test_k3_order_through_autograd(split):
    """``blend_exact(..., order=)`` under autograd, as a rank of the
    tile-sharded exact render calls it: the rows of the tiles left out of
    ``order`` are zero; K4 walks the order's tiles alone, so the attrs
    grads equal the unrestricted call's on those tiles' windows and are
    zero on every other window; the background grad sums the order's tiles
    alone.  The cotangent is nonzero on every tile, so a left-out tile's
    cotangent reaching the backward would show."""
    attrs, vcounts, wt, last_v, tiles_x = toy_exact_layout()
    t = last_v.shape[0]
    order = {"first_half": torch.arange(t // 2),
             "second_half": torch.arange(t // 2, t),
             "deepest": cb.exact_tile_order(wt, last_v)[:3].to(
                 torch.int64).flip(0)}[split].to(torch.int32)
    g_out = torch.tensor(np.random.default_rng(41).normal(
        0, 1, (t, 8, 256)).astype(np.float32))

    def run(order_):
        a = attrs.clone().requires_grad_(True)
        bg = torch.tensor([[0.3, 0.2, 0.1]], requires_grad=True)
        out = cb.blend_exact(a, vcounts, wt, last_v, bg, tiles_x,
                             order=order_)
        torch.sum(out * g_out).backward()
        return out.detach(), a.grad, bg.grad

    out_all, d_all, gbg_all = run(None)
    out_sub, d_sub, gbg_sub = run(order)
    mine = torch.zeros(t, dtype=torch.bool)
    mine[order.to(torch.int64)] = True
    assert torch.equal(out_sub[mine], out_all[mine])
    assert not out_sub[~mine].any()
    # Windows of the order's tiles: [last_v - wt[last_v], last_v].
    v_last = last_v.to(torch.int64)[mine]
    v_first = v_last - wt.to(torch.int64)[v_last]
    win = torch.zeros(attrs.shape[0], dtype=torch.bool)
    for a, b in zip(v_first.tolist(), v_last.tolist()):
        win[a:b + 1] = True
    assert d_all[win].any()
    assert torch.equal(d_sub[win], d_all[win])
    assert not d_sub[~win].any()
    t_final = torch.exp(out_all[mine, cb.OT])
    want_bg = torch.sum(t_final[:, None] * g_out[mine, :3], dim=(0, 2))
    np.testing.assert_allclose(gbg_sub[0].numpy(), want_bg.numpy(),
                               rtol=1e-5)
