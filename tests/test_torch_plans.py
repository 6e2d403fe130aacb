"""The launch plans of kernels A, B, C, D and F, which the wrappers compute in
plain Python before they launch: kernel A's route and tiling by row count
(ops/quant._plan; the streaming GEMV's ops/quant._gemv_plan, whose thread
mapping csrc/weight_stream.cuh repeats on the card), the two streaming passes
a layer of kernels C and D (ops/head_fused._plan, ops/vocoder_fused._plan),
kernel F's row tiles and key horizons (ops/flash_attention._ring_plan,
_ring_tile, as csrc/flash_ring.cu computes them), kernel B's decode tiles
and key splits (ops/flash_attention._decode_plan, _decode_split, whose
arithmetic csrc/flash_decode.cu repeats on the card), its prefill tiles and
key splits (_prefill_plan, _prefill_split), and the training attention's
route and tile walks (ops/flash_attention._train_plan, _train_walk, which
csrc/flash_train.cu reads). The 1.5B's shapes and the 7B's (hidden 3584,
28 query heads over 4 KV heads of 128, FFN 18944, an untied lm_head of
152,064 columns, a 3584-10752 diffusion head, 32,768 positions)."""

import inspect
import math

import numpy as np
import pytest
import torch

from vibevoice_tpu_torch.ops import flash_attention as fa
from vibevoice_tpu_torch.ops import head_fused as hf
from vibevoice_tpu_torch.ops import quant
from vibevoice_tpu_torch.ops import vocoder_fused as vf

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
    (2, 2, 6, 2, 64), (3, 7, 3, 2, 1000), (1, 100, 7, 4, 100000), (8, 2048, 7, 4, 32768),
    (1, 2048, 7, 4, 32768), (1, 105, 7, 4, 4096), (1, 2048, 7, 4, 16384)])
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
    (1, 12, 2, 2, 64), (2, 1, 7, 4, 4096), (2, 1, 7, 4, 32768), (8, 1, 7, 4, 4096)])
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


@pytest.mark.parametrize("s", [4096, 65536, 32768])
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


def _fold_positions(w, g):
    """Each folded row's query position, by folding a (1, W, KH, G) tensor
    of positions as the wrappers fold q (flash_attention._fold_heads): an
    account of the layout independent of the kernels' ``r // G``."""
    pos = torch.arange(w)[None, :, None, None].expand(1, w, 1, g).float()[..., None]
    return fa._fold_heads(pos.reshape(1, w, g, 1), 1)[0, 0, :, 0].long().numpy()


@pytest.mark.parametrize("kind,w,s,base", [
    ("decode", 1, 4096, 4095), ("decode", 1, 4096, 137), ("decode", 1, 32768, 16384),
    ("decode", 1, 32768, 0), ("prefill", 2048, 32768, 14336), ("prefill", 2048, 32768, 0),
    ("prefill", 2048, 32768, 31000), ("prefill", 105, 4096, 0)])
def test_tile_horizons_at_7b_gqa(kind, w, s, base):
    """Kernel B at the 7B's layout (G 7 query heads a KV head, KH 4), where
    a row tile (16 folded rows for bf16 decode, 64 for prefill) holds rows
    of several query positions, and the last tile of a chunk runs past the
    W * G rows: each tile's key horizon, computed as csrc/flash_decode.cu
    and csrc/flash_prefill.cu compute it from base (min(base + (row0 + nr -
    1) // G + 1, S)), is one past the tile's last live key by the brute-force
    mask, its splits under the wrapper's plan cover the live key tiles once,
    and the key tiles the prefill kernel leaves unmasked (below the tile's
    first row's slot, base + row0 // G) hold only live pairs."""
    g, kh, b = 7, 4, 2
    rows = fa.DECODE_ROWS[torch.bfloat16] if kind == "decode" else fa.PREFILL_ROWS
    keys = fa.DECODE_KEYS if kind == "decode" else fa.PREFILL_KEYS
    plan, split = ((fa._decode_plan, fa._decode_split) if kind == "decode"
                   else (fa._prefill_plan, fa._prefill_split))
    tiles, n_splits = (plan(b, w, g, kh, s, rows) if kind == "decode" else plan(b, w, g, kh, s))
    assert tiles == math.ceil(w * g / rows)
    pos = base + _fold_positions(w, g)  # each folded row's last live key
    assert (pos == base + np.arange(w * g) // g).all()
    for t in range(tiles):
        row0, nr = t * rows, min(rows, w * g - t * rows)
        live = (np.arange(s)[None] <= pos[row0:row0 + nr, None])  # (nr, S)
        total = min(base + (row0 + nr - 1) // g + 1, s)
        assert total == np.flatnonzero(live.any(0)).max() + 1
        seen = []
        for sp in range(n_splits):
            first, end = split(total, n_splits, sp)
            seen += range(first, end)
        nblk = math.ceil(total / keys)
        assert sorted(seen) == list(range(nblk))
        if kind == "prefill":
            lim_min = base + row0 // g
            unmasked = [j for j in range(nblk)
                        if not (j * keys + keys - 1 > lim_min or j * keys + keys > s)]
            for j in unmasked:
                assert live[:, j * keys:(j + 1) * keys].all()


DECODE_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]  # chip_smoke's LM_SHAPES
# the 7B decoder's int8 linears (q/o, k/v, gate/up, down) and its untied lm_head
DECODE_SHAPES_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064)]


@pytest.mark.parametrize("rows", range(1, quant.GEMM_MIN_ROWS))
@pytest.mark.parametrize("k,n", DECODE_SHAPES + [(64, 64), (320, 1008), (1536, 151936)])
def test_gemv_plan_reads_every_weight_once(rows, k, n):
    """The streaming GEMV's grid and thread mapping (csrc/weight_stream.cuh:
    128 threads = 16 k lanes x 8 groups of 16 columns, 8 loads a round) under
    the plan: every output column and row is owned by one block, every k by
    one (split, k lane, round, slot), and the x slice fits the shared memory
    a block may take without asking. The plan depends on the shapes alone."""
    _gemv_plan_covers_once(rows, k, n)


@pytest.mark.parametrize("rows", [1, 2, 4, 8, quant.GEMM_MIN_ROWS - 1])
@pytest.mark.parametrize("k,n", DECODE_SHAPES_7B)
def test_gemv_plan_reads_every_weight_once_7b(rows, k, n):
    """The same at the 7B's decode shapes, where the plans take more blocks
    than one wave (gate/up at 2 rows 148 column tiles x 7 splits, down 37
    splits, the lm_head 1,188 x 7): still every weight byte read once."""
    _gemv_plan_covers_once(rows, k, n)


def _gemv_plan_covers_once(rows, k, n):
    assert list(inspect.signature(quant._gemv_plan).parameters) == ["rows", "k", "n", "wbytes"]
    rt, splits, kps = quant._gemv_plan(rows, k, n)
    assert quant._plan(rows, k, n) == ("gemv", rt, quant.GEMV_COLS, splits, kps)
    assert rt in quant.GEMV_ROW_TILES and (rt == 1) == (rows == 1)
    assert (rt == 4) == (rows > 2 and rows * k * n >= quant.GEMV_WIDE_TILE_MACS)
    assert kps % 16 == 0 and 16 <= kps <= quant.GEMV_MAX_KPS and splits == math.ceil(k / kps)
    kl_n, unroll = 16, 8
    kpad = math.ceil(kps / (kl_n * unroll)) * kl_n * unroll
    assert rt * kpad * 4 + 4 * rt * quant.GEMV_COLS * 4 + 16 <= 48 * 1024
    seen_k = np.zeros(k, int)
    for split in range(splits):
        kb, ke = split * kps, min(k, (split + 1) * kps)
        assert kb < ke
        nit = math.ceil((ke - kb) / (kl_n * unroll))
        kk = (np.arange(kl_n)[:, None] + kl_n * np.arange(nit * unroll)[None]).ravel()
        assert kk.max() < kpad
        np.add.at(seen_k, kb + kk[kb + kk < ke], 1)
    assert (seen_k == 1).all()
    seen_n = np.zeros(n, int)
    for blk in range(math.ceil(n / quant.GEMV_COLS)):
        for cg in range(8):
            n0 = blk * quant.GEMV_COLS + cg * 16
            if n0 < n:
                seen_n[n0:n0 + 16] += 1
    assert (seen_n == 1).all() and n % 16 == 0
    seen_r = np.zeros(rows, int)
    for z in range(math.ceil(rows / rt)):
        seen_r[z * rt:z * rt + rt] += 1
    assert (seen_r == 1).all()


@pytest.mark.parametrize("k,n", DECODE_SHAPES + DECODE_SHAPES_7B)
def test_gemv_plan_fills_the_card(k, n):
    """At the 1.5B's and the 7B's decode shapes the K axis is split until the
    grid holds at least a block per SM (k/v, 0.4 MB at the 1.5B and 1.8 MB
    at the 7B, is too small for that at 1 and 2 rows: one round of loads a
    block), and never past one wave of the blocks it aims at unless a block
    already takes the most k it can stage (the 7B's wide linears all do)."""
    for rows in (1, 2, 4, 8):
        rt, splits, kps = quant._gemv_plan(rows, k, n)
        blocks = math.ceil(n / quant.GEMV_COLS) * math.ceil(rows / rt) * splits
        assert blocks >= quant.SMS or kps == quant.GEMV_MIN_KPS
        if kps < quant.GEMV_MAX_KPS:  # one wave of the blocks the split aims at
            assert blocks <= quant.SMS * quant.GEMV_ROW_TILES[rt] + math.ceil(n / quant.GEMV_COLS)


def _stream_pass_covers_once(rows, k, n, wbytes, plan):
    """One launch of the streaming core (csrc/weight_stream.cuh) over a (k, n)
    weight of ``wbytes`` bytes an element under ``plan``: 128 threads = 16 k
    lanes x 8 groups of one 16-byte vector, 8 loads a round. Every weight
    byte is read by exactly one (split, k lane, round, slot, column group),
    every output owned by one block, and the x slice plus the block's
    reduction buffer fit the shared memory a block may take without asking.
    Returns the launch's block count."""
    rt, splits, kps = plan
    cols = quant.GEMV_COLS // wbytes
    assert rt in quant.GEMV_ROW_TILES and kps % 16 == 0 and 16 <= kps <= quant.GEMV_MAX_KPS
    assert splits == math.ceil(k / kps) and n % 16 == 0
    kl_n, unroll = 16, 8
    kpad = math.ceil(kps / (kl_n * unroll)) * kl_n * unroll
    assert rt * kpad * 4 + 4 * rt * cols * 4 + 16 <= 48 * 1024
    vc = 16 // wbytes  # columns of a 16-byte vector
    starts = np.array([blk * cols + cg * vc for blk in range(math.ceil(n / cols))
                       for cg in range(8)])
    starts = starts[starts < n] // vc  # the vectors some thread reads, by index
    seen = np.zeros(k * (n // vc), np.int64)  # 16-byte weight vectors, row-major (k, n // vc)
    for split in range(splits):
        kb, ke = split * kps, min(k, (split + 1) * kps)
        assert kb < ke
        nit = math.ceil((ke - kb) / (kl_n * unroll))
        kk = (np.arange(kl_n)[:, None] + kl_n * np.arange(nit * unroll)[None]).ravel()
        idx = (kb + kk[kb + kk < ke])[:, None] * (n // vc) + starts[None]
        seen += np.bincount(idx.ravel(), minlength=seen.size)
    assert (seen == 1).all()
    seen_r = np.zeros(rows, int)
    for z in range(math.ceil(rows / rt)):
        seen_r[z * rt:z * rt + rt] += 1
    assert (seen_r == 1).all()
    return math.ceil(n / cols) * math.ceil(rows / rt) * splits


# (kernel, width, FFN width): the 1.5B's diffusion head and vocoder stage,
# tiny_config's, and the 7B's head (its vocoder stage is the 1.5B's)
FUSED_SHAPES = [("C", 1536, 4608), ("D", 2048, 8192), ("C", 64, 192), ("D", 16, 64),
                ("C", 3584, 10752)]


@pytest.mark.parametrize("wbytes", [1, 2, 4])
@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("kernel,dim,hid", FUSED_SHAPES)
def test_head_and_stage_plans_read_every_weight_once(kernel, dim, hid, rows, wbytes):
    """Kernels C and D run each layer's FFN as two launches of the streaming
    core: C gate|up (dim -> 2 hid, the two matrices side by side) and down
    (hid -> dim), D fc1 (dim -> hid) and fc2 (hid -> dim). Under their plans,
    from the shapes alone, every weight byte is read once, and at the 1.5B
    and 7B shapes each launch fills one wave of the SMs (a block per SM at
    least) and no more than one wave of the blocks its split aims at unless
    a block already takes the most k it can stage."""
    mod = hf if kernel == "C" else vf
    assert list(inspect.signature(mod._plan).parameters) == ["rows", "dim", "hid", "wbytes"]
    first, second = mod._plan(rows, dim, hid, wbytes)
    n_first = 2 * hid if kernel == "C" else hid
    for (k, n), plan in (((dim, n_first), first), ((hid, dim), second)):
        assert plan == quant._gemv_plan(rows, k, n, wbytes)
        blocks = _stream_pass_covers_once(rows, k, n, wbytes, plan)
        if dim >= 1536:
            assert blocks >= quant.SMS
            rt, _, kps = plan
            if kps < quant.GEMV_MAX_KPS:
                assert blocks <= (quant.SMS * quant.GEMV_ROW_TILES[rt]
                                  + math.ceil(n / (quant.GEMV_COLS // wbytes)))


@pytest.mark.parametrize("dim,hid", [(1536, 4600), (1540, 4608), (24, 64), (16, 72)])
@pytest.mark.parametrize("kernel", ["C", "D"])
def test_head_and_stage_plans_refuse_ragged_widths(kernel, dim, hid):
    """A width that is not a multiple of 16 splits a 16-byte vector of
    columns: both plans refuse it (the CPU path, the plain version, takes
    any width)."""
    mod = hf if kernel == "C" else vf
    with pytest.raises(ValueError, match="multiples of 16"):
        mod._plan(2, dim, hid, 1)


def _ring_live(w, g, s, q_start, k_start, k_len):
    """Brute force: live[r, j] for folded row r = w * g + gi and key j."""
    pos = q_start + np.arange(w * g) // g
    key = k_start + np.arange(s)
    return (key[None, :] <= pos[:, None]) & (key[None, :] < k_len)


@pytest.mark.parametrize("dtype_rows", [64, 32])
@pytest.mark.parametrize("g", [3, 6, 7])
@pytest.mark.parametrize("w,s,q_start,k_start", [
    (100, 100, 100, 100),  # the rank's own block
    (100, 100, 100, 0),    # an earlier rank's
    (100, 100, 100, 200),  # a later rank's: wholly in the future
    (77, 130, 0, 0),       # a world of one, ragged rows and keys
    (45, 200, 150, 0),     # keys beyond every row's slot
])
@pytest.mark.parametrize("k_len", ["inside", "before", "after", "at_start"])
def test_ring_tiles_match_the_mask(w, s, q_start, k_start, g, dtype_rows, k_len):
    """Kernel F's tile arithmetic against the brute-force mask, ragged W, G 3,
    6 and 7 (the 7B's, whose 64-row tiles straddle query positions), k_len
    inside, before and after the block: a tile's horizon is one
    past its last live key (0 and skipped iff it has none), and the key
    tiles it leaves unmasked hold only live pairs."""
    k_len = {"inside": k_start + s // 3, "before": max(k_start - 5, 0), "after": k_start + s + 50,
             "at_start": k_start}[k_len]
    live = _ring_live(w, g, s, q_start, k_start, k_len)
    rows, tiles = dtype_rows, math.ceil(w * g / dtype_rows)
    assert fa._ring_plan(w, g) == (fa.RING_ROWS, math.ceil(w * g / fa.RING_ROWS))
    covered = np.zeros(w * g, int)
    for t in range(tiles):
        row0, horizon, unmasked = fa._ring_tile(t, rows, w, g, s, q_start, k_start, k_len)
        assert row0 == t * rows
        blk = live[row0:row0 + rows]
        covered[row0:row0 + rows] += 1
        cols = np.flatnonzero(blk.any(0))
        assert horizon == (cols.max() + 1 if cols.size else 0)
        assert 0 <= unmasked * fa.RING_KEYS <= horizon
        assert blk[:, :unmasked * fa.RING_KEYS].all()
        if unmasked * fa.RING_KEYS < horizon:  # the next key tile does cross a horizon
            nxt = blk[:, unmasked * fa.RING_KEYS:(unmasked + 1) * fa.RING_KEYS]
            assert not nxt.all() or nxt.shape[1] < fa.RING_KEYS
    assert (covered == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_plan_routes_by_dtype_and_head_dim(dtype):
    """The training attention's route comes from (dtype, D) alone: the
    tensor-core kernels at D 64 and 128, the CUDA-core kernels at D 16 and
    32; any other head dim or dtype raises (no route stands in for another)."""
    for d, route in ((64, "wgmma"), (128, "wgmma"), (16, "cuda_cores"), (32, "cuda_cores")):
        assert fa._train_plan(dtype, d) == route
    for d in (8, 48, 96, 256):
        with pytest.raises(ValueError):
            fa._train_plan(dtype, d)
    with pytest.raises(ValueError):
        fa._train_plan(torch.float16, 128)


def _segments(kind, t, rng):
    """(B, T) int32 segment ids: a right-padded batch (valid 1, pad 0; one
    sample full, one ragged, one with a single valid token), packed runs of
    distinct ids, or ids in no order (runs broken up)."""
    if kind == "padded":
        seg = np.zeros((3, t), np.int32)
        for i, n in enumerate((t, max(1, (2 * t) // 3 + 5) if t > 1 else 1, 1)):
            seg[i, :min(n, t)] = 1
        return seg
    if kind == "packed":
        cuts = np.sort(rng.choice(np.arange(1, t), size=min(5, t - 1), replace=False)) if t > 1 else []
        return np.repeat(np.arange(len(cuts) + 1, dtype=np.int32),
                         np.diff(np.concatenate([[0], cuts, [t]])).astype(int))[None]
    return rng.randint(0, 3, (2, t)).astype(np.int32)


@pytest.mark.parametrize("t,kind", [
    (t, kind) for t in (1, 63, 64, 65, 130, 1500, 2048, 8192) for kind in ("padded", "packed")
] + [(t, "scattered") for t in (1, 63, 65, 130, 1500)])
def test_train_tiles_match_the_mask(t, kind):
    """The tensor-core route's tile walks (_train_walk, read by
    csrc/flash_train.cu) against the brute-force mask (key j live for query
    i iff j <= i and seg[j] == seg[i]): the forward's and dQ's key tiles of a
    query tile run from kfirst to the diagonal, dK/dV's query tiles of a key
    tile from the diagonal to qlast; every live pair lies in exactly one
    tile of each walk, and where the segments are runs (a right-padded batch,
    packed sequences) no tile of a walk is dead."""
    rng = np.random.RandomState(t)
    seg = _segments(kind, t, rng)
    kfirst, qlast = (x.numpy() for x in fa._train_walk(torch.from_numpy(seg)))
    tl, nt = fa.TRAIN_TILE, math.ceil(t / fa.TRAIN_TILE)
    assert kfirst.shape == qlast.shape == (seg.shape[0], nt)
    for b in range(seg.shape[0]):
        live_tiles = np.zeros((nt, nt), bool)  # [query tile, key tile]
        for qt in range(nt):
            rows = np.arange(qt * tl, min(t, qt * tl + tl))
            live = (np.arange(t)[None] <= rows[:, None]) & (seg[b][None] == seg[b, rows][:, None])
            pad = np.zeros((len(rows), nt * tl - t), bool)
            live_tiles[qt] = np.concatenate([live, pad], 1).reshape(len(rows), nt, tl).any((0, 2))
        for i in range(nt):
            fwd = np.zeros(nt, bool)
            fwd[kfirst[b, i]:i + 1] = True  # the forward's and dQ's walk of query tile i
            assert not (live_tiles[i] & ~fwd).any()
            bwd = np.zeros(nt, bool)
            bwd[i:qlast[b, i] + 1] = True  # dK/dV's walk of key tile i
            assert not (live_tiles[:, i] & ~bwd).any()
            if kind != "scattered":
                assert live_tiles[i][fwd].all() and live_tiles[:, i][bwd].all()


@pytest.mark.parametrize("t", [1, 7, 300])
def test_segment_bounds_brute_force(t):
    rng = np.random.RandomState(t)
    seg = rng.randint(-2, 3, (3, t)).astype(np.int32)
    first, last = (x.numpy() for x in fa._seg_bounds(torch.from_numpy(seg)))
    for b in range(3):
        for i in range(t):
            same = np.flatnonzero(seg[b] == seg[b, i])
            assert first[b, i] == same.min() and last[b, i] == same.max()


# Kernel A's shapes on the rest of the JAX package's surface: the packed
# q|k|v and gate|up of an int8 LM (LM_PACK=1), the int8 diffusion head
# (FFN and AdaLN, ratio 3) and the int8 tokenizer FFNs (C, 4C) at C = 512,
# 1024 and 2048, at the 1.5B's and the 7B's widths.
SURFACE_SHAPES = [(1536, 2048), (1536, 17920), (3584, 4608), (3584, 37888),  # qkv, gateup
                  (1536, 4608), (4608, 1536), (3584, 10752), (10752, 3584),  # head
                  (512, 2048), (2048, 512), (1024, 4096), (4096, 1024), (2048, 8192),
                  (8192, 2048)]  # tokenizer FFNs


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 20, quant.GEMM_MIN_ROWS - 1])
@pytest.mark.parametrize("k,n", SURFACE_SHAPES)
def test_gemv_plan_reads_every_weight_once_surface(rows, k, n):
    """The streaming GEMV at the surface's shapes and decode rows (a frame's
    T = 1 tokenizer stages at 1-4 rows, the head's FFN at 2 and 8, its
    AdaLN at K x 2B = 20): every weight byte read once, as at the LM's."""
    _gemv_plan_covers_once(rows, k, n)


@pytest.mark.parametrize("k,n", SURFACE_SHAPES)
def test_int8_plan_at_surface_shapes(k, n):
    """The route by rows alone at the surface's shapes: the GEMV below
    GEMM_MIN_ROWS (decode, the AdaLN at 20 rows), the GEMM from there (the
    AdaLN at bs4's 80 rows, a voice prompt's 75-300 tokenizer rows), which
    covers every output once without splitting K; the GEMV's split fills
    the card as test_gemv_plan_fills_the_card holds it."""
    for rows in (1, 2, 8, 20, 39, 40, 80, 300):
        test_int8_plan_covers_every_output_and_k_once(rows, k, n)
    for rows in (1, 2, 4, 8):
        rt, splits, kps = quant._gemv_plan(rows, k, n)
        blocks = math.ceil(n / quant.GEMV_COLS) * math.ceil(rows / rt) * splits
        assert blocks >= quant.SMS or kps == quant.GEMV_MIN_KPS
