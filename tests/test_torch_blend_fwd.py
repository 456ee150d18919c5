"""PyTorch port, the forward blend kernels' redesign (K3's window split,
launch order and the warp skip of ``csrc/blend_fwd.cuh``), on CPU tensors:

- ``exact_split_plan``, the block tables K3 launches from (tile order
  unless given an order);
- ``blend_exact_split_plain``, the plain twin of the split (phases A, B
  and C), against ``blend_exact_plain`` and JAX's ``_blend_exact`` in
  interpret mode on the same numpy inputs, at the forward bar of
  tests/test_pallas_blend.py (2e-5 on rows R, G, B, invdepth, alpha and
  log T; n_contrib equal to the plain version's, and to min(nc_jax, count)
  for JAX, whose n_contrib also counts padding lanes);
- ``alpha_skip_threshold``, which the kernels' skip threshold mirrors;
- ``blend_exact(order=)``'s checks, and its plain version's rows for an
  order of all the tiles (the same) or some (zero elsewhere).

``chip_smoke.py`` holds the CUDA kernels against these plain versions on
the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from street_sparse_3dgs_tpu.ops import pallas_blend as jpb
from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
from test_torch_blend import TILES_X, compare, exact_layout, random_slots

torch.set_num_threads(1)
ATOL = 2e-5
K = 128


def layout_tensors(tile_counts, extra=3):
    vcounts, wt, last_v, t_of_v = exact_layout(tile_counts, K, extra)
    return (torch.tensor(vcounts), torch.tensor(wt), torch.tensor(last_v),
            t_of_v)


PLAN_CASES = {
    "shallow_only": ([0, 5, 128, 200], 2, False),
    "mixed_g1": ([300, 0, 1000, 129, 40, 640], 1, False),
    "mixed_g2": ([300, 0, 1000, 129, 40, 640], 2, False),
    "mixed_g3": ([300, 0, 1000, 129, 40, 640, 2000], 3, False),
    "mixed_g8": ([300, 0, 1000, 129, 40, 640, 2000], 8, False),
    "reversed_subset_g2": ([300, 0, 1000, 129, 40, 640], 2, True),
    "no_split": ([300, 0, 1000, 129], 0, False),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_split_plan_covers_every_window_once(case):
    """Every window of every tile of the order is covered exactly once, a
    tile's groups come in window order with consecutive scratch slots, a
    tile of at most G windows is one block, the pass-2 table lists the
    groups after each group 0 in table order, the combine table lists the
    split tiles in order, and no table outgrows its bound.  Without an
    order the tiles come in tile order."""
    tile_counts, group, subset = PLAN_CASES[case]
    vcounts, wt, last_v, _ = layout_tensors(tile_counts)
    t, nv = last_v.shape[0], vcounts.shape[0]
    order = cb.exact_tile_order(wt, last_v)
    if subset:
        order = order.flip(0)[1:].contiguous()
    table, pass2, combine, slots = cb.exact_split_plan(vcounts, wt, last_v,
                                                       group, order)
    assert table.dtype == pass2.dtype == combine.dtype == torch.int32
    in_tile_order = cb.exact_split_plan(vcounts, wt, last_v, group)
    want = cb.exact_split_plan(vcounts, wt, last_v, group,
                               torch.arange(t, dtype=torch.int32))
    for a, b in zip(in_tile_order[:3], want[:3]):
        assert torch.equal(a, b)
    rows = table.tolist()
    used = [r for r in rows if r[0] >= 0]
    assert all(r[0] < 0 for r in rows[len(used):])   # padding at the end
    assert [r[0] for r in used] == sorted(
        [r[0] for r in used], key=order.tolist().index)
    nw = (wt.to(torch.int64)[last_v.to(torch.int64)] + 1).tolist()
    q_seen = []
    split_tiles = []
    for ti in order.tolist():
        mine = [r for r in used if r[0] == ti]
        first = int(last_v[ti]) - nw[ti] + 1
        covered = [v for r in mine for v in range(r[1], r[1] + r[2])]
        assert covered == list(range(first, first + nw[ti])), (ti, mine)
        if group <= 0 or nw[ti] <= group:
            assert len(mine) == 1 and mine[0][3] == -1
        else:
            assert all(r[2] <= group for r in mine)
            assert len(mine) == -(-nw[ti] // group)
            qs = [r[3] for r in mine]
            assert qs == list(range(qs[0], qs[0] + len(qs)))
            q_seen += qs
            split_tiles.append([ti, qs[0], len(qs)])
    for ti in range(t):
        if ti not in order.tolist():
            assert all(r[0] != ti for r in used)
    assert sorted(q_seen) == list(range(len(q_seen)))
    assert len(q_seen) <= slots
    later = [r for r in used
             if r[3] >= 0 and r[1] > int(last_v[r[0]]) - nw[r[0]] + 1]
    p2 = [r for r in pass2.tolist() if r[0] >= 0]
    assert p2 == later
    assert all(r[0] < 0 for r in pass2.tolist()[len(p2):])
    comb = [r for r in combine.tolist() if r[0] >= 0]
    assert comb == split_tiles
    assert all(r[0] < 0 for r in combine.tolist()[len(comb):])
    if group > 0:
        extra = (nv - t) // group
        assert table.shape[0] == order.shape[0] + extra
        assert pass2.shape[0] == combine.shape[0] == extra
        assert slots == 2 * (nv - t) // group
    if case == "mixed_g2":
        assert split_tiles and len(used) > t


def uniform_slots(n, end, op_before):
    """[n, 10] slots over a 64x48 frame that every pixel sees alike
    (conics 1e-9: power within 1e-5 of 0): opacity ``op_before`` up to slot
    ``end`` - 1, 0.99 at slot ``end`` (where every pixel terminates), faint
    after it."""
    s = np.zeros((n, 10), np.float32)
    s[:, 0], s[:, 1] = 32.0, 24.0
    s[:, 2] = s[:, 4] = 1e-9
    rng = np.random.default_rng(n + end)
    s[:, 5:8] = rng.uniform(0, 1, (n, 3))
    s[:, 9] = rng.uniform(0.1, 0.5, n)
    s[:, 8] = op_before
    s[end:, 8] = 0.02
    s[end, 8] = 0.99
    return s


def terminating_at(end):
    """An opacity below ``end`` that leaves T at 1e-4 ** 0.85 after ``end``
    slots, so that slot ``end`` (0.99) ends the walk."""
    return float(1.0 - np.exp(np.log(1e-4) * 0.85 / end))


def split_inputs(group, where):
    """An exact layout (K = 128) of 8 real tiles and its attrs: random
    tiles of every depth, and one or two tiles whose every pixel terminates
    ``where``: inside group 0, on the last slot of a group, or inside a
    later group."""
    rng = np.random.default_rng(7 + group)
    span = group * K
    ends = {"in_group_0": [span // 2],
            "on_group_end": [span - 1, 2 * span - 1],
            "in_later_group": [span + 50, 2 * span + 17]}[where]
    tile_counts = [0, 300, 1000, 129, 40, 700] + [e + 200 for e in ends]
    vcounts, wt, last_v, t_of_v = exact_layout(tile_counts, K, 4)
    attrs = np.zeros((vcounts.shape[0], K, 10), np.float32)
    for ti, cnt in enumerate(tile_counts):
        if ti >= 6:
            end = ends[ti - 6]
            slots = uniform_slots(cnt, end, terminating_at(end))
        else:
            slots = random_slots(rng, max(cnt, 1), ti % 2 == 1)
        first = last_v[ti] - wt[last_v[ti]]
        for j in range(wt[last_v[ti]] + 1):
            part = slots[j * K:(j + 1) * K]
            attrs[first + j, :len(part)] = part
    attrs[t_of_v == len(tile_counts)] = rng.uniform(
        0, 1, attrs[t_of_v == len(tile_counts)].shape)
    return attrs, vcounts, wt, last_v, t_of_v, tile_counts, ends


SPLIT_CASES = [(g, w) for g in (1, 2, 3)
               for w in ("in_group_0", "on_group_end", "in_later_group")]


@pytest.mark.parametrize("group,where", SPLIT_CASES)
def test_split_plain_matches_exact_plain_and_jax(group, where):
    attrs, vcounts, wt, last_v, t_of_v, tile_counts, ends = split_inputs(
        group, where)
    bg = np.array([[0.3, 0.2, 0.1]], np.float32)
    args = [torch.tensor(x) for x in (attrs, vcounts, wt, last_v, bg)]
    got = cb.blend_exact_split_plain(*args, TILES_X, group=group)
    want = cb.blend_exact_plain(*args, TILES_X)
    np.testing.assert_allclose(got[:, :6].numpy(), want[:, :6].numpy(),
                               rtol=0, atol=ATOL)
    assert torch.equal(got[:, 6], want[:, 6])
    for i, end in enumerate(ends):
        # Every pixel of the crafted tiles terminated on its slot ``end``.
        assert (got[6 + i, 6] == end).all(), (end, got[6 + i, 6].unique())
    nv, t = vcounts.shape[0], len(tile_counts)
    t_safe = np.minimum(t_of_v, t - 1)
    is_last = (t_of_v >= t) | (np.arange(nv) == last_v[t_safe])
    meta = np.stack([t_safe, wt, vcounts, is_last.astype(np.int32)])
    jax_out = jpb._blend_exact(True, TILES_X, 1, None, None, 0,
                               jnp.asarray(meta), jnp.asarray(last_v),
                               jnp.asarray(attrs), jnp.asarray(bg))
    compare(got, jax_out, np.array(tile_counts))


def test_split_plain_dead_on_entry_counts_skipped_slots():
    """A group entered below log(1e-4) adds no colour and keeps the log T
    of the group before; its slots up to its first passing one count in
    n_contrib, as in a walk of the whole tile, and no later group adds."""
    group = 1
    end = K - 1                       # every pixel ends on window 0's last
    slots = uniform_slots(3 * K, end, terminating_at(end))
    # Window 1 opens with 20 slots no pixel sees, then a passing one.
    slots[K:K + 20, 0] = 1e4
    attrs = slots.reshape(3, K, 10)
    vcounts, wt, last_v, _ = exact_layout([3 * K], K, 0)
    args = [torch.tensor(x) for x in (attrs, vcounts, wt, last_v,
                                      np.array([[0.3, 0.2, 0.1]],
                                               np.float32))]
    got = cb.blend_exact_split_plain(*args, 1, group=group)
    want = cb.blend_exact_plain(*args, 1)
    np.testing.assert_allclose(got[:, :6].numpy(), want[:, :6].numpy(),
                               rtol=0, atol=ATOL)
    assert torch.equal(got[:, 6], want[:, 6])
    assert (got[:, 6] == end).all()


def test_skip_threshold_never_skips_a_passing_slot():
    """Over op in [1/255, 1] (and below it) and power in float32 steps
    around each op's threshold, no (op, power) that passes the alpha test
    (computed as the plain versions do) lies below the threshold; and the
    margin is tight: just below the threshold nothing passes, while some
    power within 2 * SKIP_DELTA above it does."""
    rng = np.random.default_rng(3)
    op = np.concatenate([
        np.linspace(1.0 / 255.0, 1.0, 2001), rng.uniform(1 / 255, 1, 2000),
        np.nextafter(np.float32(1 / 255), [0, 1]).astype(np.float64),
        [1 / 255 * 0.999, 1e-3, 0.0]]).astype(np.float32)
    op_t = torch.tensor(op)
    thr = cb.alpha_skip_threshold(op_t)
    assert torch.isinf(thr[op_t < cb.ALPHA_MIN]).all()
    finite = torch.isfinite(thr)
    assert finite.sum() >= 4000
    # Powers from thr - 4 delta to thr + 4 delta in float32 steps of
    # delta / 64, plus the neighbours of thr itself.
    steps = torch.arange(-256, 257, dtype=torch.float32) * (cb.SKIP_DELTA
                                                            / 64)
    p = torch.clamp(thr[finite, None] + steps[None, :], max=0.0)
    near = torch.stack([torch.nextafter(thr[finite], torch.tensor(-1e9)),
                        thr[finite]], dim=1)
    p = torch.cat([p, near], dim=1)
    o = op_t[finite, None].expand_as(p)
    alpha = torch.clamp(o * torch.exp(torch.clamp(p, max=0.0)),
                        max=cb.ALPHA_MAX)
    passes = (p <= 0.0) & (alpha >= cb.ALPHA_MIN)
    skipped = (p < thr[finite, None]) | (p > 0.0)
    assert not (passes & skipped).any()
    assert passes.any()
    # Tight: a power delta / 2 above the threshold still fails somewhere
    # (the margin is not far larger than needed) for the ops where alpha
    # is not clamped.
    below_true = p < (thr[finite, None] + cb.SKIP_DELTA * 0.5)
    assert not (passes & below_true).any()


def test_blend_exact_order_checked_and_ignored_on_cpu():
    """``blend_exact(order=)`` refuses an order of the wrong type, rank or
    length, or with an id out of range or repeated; on CPU tensors (the
    plain version) every order of all the tiles gives the same rows, and an
    order of some of them gives those tiles' rows and zero rows elsewhere,
    as the kernel path does."""
    rng = np.random.default_rng(5)
    tile_counts = [0, 300, 128, 129, 40, 512]
    vcounts, wt, last_v, _ = exact_layout(tile_counts, K, 2)
    attrs = np.zeros((vcounts.shape[0], K, 10), np.float32)
    for ti, cnt in enumerate(tile_counts):
        slots = random_slots(rng, max(cnt, 1), False)
        first = last_v[ti] - wt[last_v[ti]]
        for j in range(wt[last_v[ti]] + 1):
            part = slots[j * K:(j + 1) * K]
            attrs[first + j, :len(part)] = part
    args = [torch.tensor(x) for x in (attrs, vcounts, wt, last_v,
                                      np.array([[0.3, 0.2, 0.1]],
                                               np.float32))]
    want = cb.blend_exact(*args, TILES_X)
    t = last_v.shape[0]
    deepest = cb.exact_tile_order(args[2], args[3])
    for order in (deepest, deepest.flip(0).contiguous(),
                  torch.arange(t, dtype=torch.int32)):
        assert torch.equal(cb.blend_exact(*args, TILES_X, order=order), want)
    one = deepest[:1].clone()
    got = cb.blend_exact(*args, TILES_X, order=one)
    mine = torch.zeros(t, dtype=torch.bool)
    mine[one.to(torch.int64)] = True
    assert torch.equal(got[mine], want[mine])
    assert not got[~mine].any()
    bad = (deepest.to(torch.int64), deepest[None, :].contiguous(),
           torch.zeros(t + 1, dtype=torch.int32),
           torch.tensor([0, t], dtype=torch.int32),
           torch.tensor([-1], dtype=torch.int32),
           torch.tensor([2, 1, 2], dtype=torch.int32))
    for order in bad:
        with pytest.raises(ValueError, match="order"):
            cb.blend_exact(*args, TILES_X, order=order)
