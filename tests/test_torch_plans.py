"""The launch plans of kernels A and B, which the wrappers compute in plain
Python before they launch: kernel A's route and tiling by row count
(ops/quant._plan), kernel B's decode tiles and key splits
(ops/flash_attention._decode_plan, _decode_split, whose arithmetic
csrc/flash_decode.cu repeats on the card) and its prefill tiles and key
splits (_prefill_plan, _prefill_split)."""

import inspect
import math

import numpy as np
import pytest

from vibevoice_tpu_torch.ops import flash_attention as fa
from vibevoice_tpu_torch.ops import quant

LM_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (64, 64), (64, 256)]


@pytest.mark.parametrize("rows", [1, 2, 63, 64, 65, 512, 4096, 32768])
@pytest.mark.parametrize("k,n", LM_SHAPES)
def test_int8_plan_covers_every_output_and_k_once(rows, k, n):
    plan = quant._plan(rows, k, n)
    assert plan.route == ("gemm" if rows >= quant.GEMM_MIN_ROWS else "gemv")
    for extent, tile in ((rows, plan.row_tile), (n, plan.col_tile)):
        cover = np.zeros(extent, int)
        for start in range(0, extent, tile):
            cover[start:start + tile] += 1
        assert (cover == 1).all()
    ranges = [(s * plan.k_per_split, min(k, (s + 1) * plan.k_per_split))
              for s in range(plan.splits)]
    assert all(a < b for a, b in ranges)  # no empty split
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    if plan.route == "gemm":  # no split-K: a row's sum never depends on the call's rows
        assert plan.splits == 1 and plan.k_per_split == k


def test_int8_route_switches_at_the_threshold():
    t = quant.GEMM_MIN_ROWS
    for k, n in LM_SHAPES:
        assert quant._plan(t - 1, k, n).route == "gemv"
        assert quant._plan(t, k, n).route == "gemm"
    # the GEMM's plan is the same at every row count: tiles and one K pass
    assert {quant._plan(r, 1536, 8960)[1:] for r in (t, 1000, 32768)} == {
        quant._plan(t, 1536, 8960)[1:]}


@pytest.mark.parametrize("b,w,g,kh,s", [
    (1, 512, 6, 2, 4096), (2, 512, 6, 2, 4096), (2, 512, 6, 2, 65536), (2, 2048, 6, 2, 32768),
    (2, 2, 6, 2, 64), (3, 7, 3, 2, 1000), (1, 100, 7, 4, 100000), (8, 2048, 7, 4, 32768)])
def test_prefill_plan_fills_the_card(b, w, g, kh, s):
    tiles, n_splits = fa._prefill_plan(b, w, g, kh, s)
    assert tiles == math.ceil(w * g / fa.PREFILL_ROWS)
    blocks = b * kh * tiles
    key_tiles = math.ceil(s / fa.PREFILL_KEYS)
    if blocks >= 2 * fa.SMS:
        assert n_splits == 1
    else:  # two waves of the SMs, unless the cache is too short to split that far
        assert blocks * n_splits >= 2 * fa.SMS or n_splits == max(1, key_tiles // 4)
    assert n_splits == 1 or key_tiles >= 4 * n_splits


@pytest.mark.parametrize("b,w,g,kh,s", [
    (2, 1, 6, 2, 4096), (2, 1, 6, 2, 65536), (4, 1, 6, 2, 32768), (1, 1, 1, 1, 64),
    (1, 1, 6, 2, 100), (16, 1, 6, 2, 4096), (64, 1, 7, 4, 8192), (3, 7, 3, 2, 1000),
    (1, 12, 2, 2, 64)])
@pytest.mark.parametrize("rows", sorted(set(fa.DECODE_ROWS.values())))
def test_decode_plan_fills_the_card(b, w, g, kh, s, rows):
    """The decode grid comes from the shapes alone (no base: a CUDA graph
    may replay the launch with other bases) and fills two waves of the SMs
    unless the cache holds fewer than two key tiles per split."""
    assert list(inspect.signature(fa._decode_plan).parameters) == ["b", "w", "g", "kh", "s",
                                                                    "rows"]
    tiles, n_splits = fa._decode_plan(b, w, g, kh, s, rows)
    assert tiles == math.ceil(w * g / rows)
    cap = min(math.ceil(math.ceil(s / fa.DECODE_KEYS) / 2), fa.DECODE_MAX_SPLITS)
    assert 1 <= n_splits <= cap
    assert b * kh * tiles * n_splits >= 2 * fa.SMS or n_splits == cap
    assert b * kh * tiles * (n_splits - 1) < 2 * fa.SMS  # no more splits than two waves need


@pytest.mark.parametrize("s", [4096, 65536])
@pytest.mark.parametrize("total", ["1", "2", "tile-1", "tile", "tile+1", "mid", "S"])
@pytest.mark.parametrize("n_splits", [1, 2, 33, 132])
def test_decode_splits_cover_the_horizon_once(total, n_splits, s):
    """A row tile whose rows attend keys [0, total): the decode splits cover
    its key tiles exactly once, no split starts past the horizon, and the
    live splits are those the kernel merges (at least one tile each)."""
    total = {"1": 1, "2": 2, "tile-1": fa.DECODE_KEYS - 1, "tile": fa.DECODE_KEYS,
             "tile+1": fa.DECODE_KEYS + 1, "mid": s // 2 + 17, "S": s}[total]
    nblk = math.ceil(total / fa.DECODE_KEYS)
    seen, live = [], 0
    for sp in range(n_splits):
        first, end = fa._decode_split(total, n_splits, sp)
        assert first <= end <= nblk
        if first < end:
            live += 1
            assert first * fa.DECODE_KEYS < total
        seen += range(first, end)
    assert sorted(seen) == list(range(nblk))
    assert live == min(n_splits, nblk)


@pytest.mark.parametrize("total", [1, 63, 64, 65, 200, 4096, 65536])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7, 100])
def test_prefill_splits_cover_the_horizon_once(total, n_splits):
    """A row tile whose rows attend keys [0, total): its splits cover the key
    tiles up to the horizon exactly once, and no split starts past it."""
    nblk = math.ceil(total / fa.PREFILL_KEYS)
    seen = []
    for sp in range(n_splits):
        first, end = fa._prefill_split(total, n_splits, sp)
        assert first <= end <= nblk
        if first < end:
            assert first * fa.PREFILL_KEYS < total
        seen += range(first, end)
    assert sorted(seen) == list(range(nblk))
