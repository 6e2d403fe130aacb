"""Weight-only int8 quantization, kernel A (the dequantizing matmul) and
kernel E (its activation gradient) (port of vibevoice_tpu/ops/quant.py).

Layout as in the JAX package: w8 (IN, OUT) int8 with per-output-column f32
scales (OUT,); w = w8 * scale. ``quantize_weight`` does the same f32
``max|w| / 127``, division and round-half-even as the JAX version, so the
int8 tensors and scales are bit-equal.

``int8_matmul`` on a CUDA tensor launches a hand-written kernel that
replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:129, by one of
three routes chosen by row count alone (``_plan``): up to ``GEMV_MAX_ROWS``
rows the one-launch weight-streaming GEMV of csrc/int8_matmul.cu (core:
csrc/weight_stream.cuh; plan ``_gemv_plan``); from there to below
``GEMM_MIN_ROWS`` (batched decode, the int8 head's AdaLN, the tokenizers
over a voice prompt, prefills of prompts and chunks, training) the split-K
tensor-core GEMM of csrc/int8_gemm_splitk.cu (TMA and wgmma, a row tile
sized to the call, K split to fill the card; plan ``_sk_plan``); from
``GEMM_MIN_ROWS`` up (the ring prefill of a long prompt) the tensor-core
GEMM of csrc/int8_gemm.cu (256 rows x 128 columns a block, no split-K).
Every plan comes from the shapes alone, and the split-K routes' workspace
and counters persist per device and stream, so a launch can be captured in
a CUDA graph. ``segments`` names
the output widths of the unpacked projections that a packed weight joins
(``pack_lm_projections``): each segment is then split as its own call
would be, so every column is summed in the same order, and gives the same
bits, packed or not. On a CPU tensor it runs ``int8_matmul_plain``, the
same function in plain PyTorch. Unlike the TPU port, every shape takes a
kernel (no 512-divisibility gate).

``int8_matmul_t`` is the backward w.r.t. x, dx = bf16(g * scale) @ w8^T: on
a CUDA tensor kernel E (csrc/int8_matmul_t.cu, replacing the Pallas TPU
kernel vibevoice_tpu/ops/quant.py:220: a cast pass forming bf16(g * scale),
then a TMA + wgmma GEMM with w8 as the register operand, no split-K; OUT a
multiple of 16 and IN of 4), on a CPU tensor
``int8_matmul_t_plain``. ``mm`` routes every int8 linear whose input needs a
gradient through ``Int8MatmulDx``, the autograd Function with kernel A
forward and kernel E backward (the JAX custom VJP ``_int8_matmul_dx``); the
int8 weights and scales are frozen and get no gradient.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from . import _cuda


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w (IN, OUT) float -> {'w8': int8 (IN, OUT), 'scale': (OUT,) f32}."""
    wf = w.float()
    # the divisor is a tensor on w's device: CUDA divides by a host scalar as
    # a multiply by its reciprocal, one ulp away from the CPU's division
    scale = wf.abs().amax(dim=0).clamp_min(1e-8) / torch.full((), 127.0, device=w.device)
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w8": wq.contiguous(), "scale": scale}


def int8_matmul_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A: bf16-rounded x, f32 sum, scale after."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w8.float()) * scale.float()
    return y.to(x.dtype)


# The routes' row thresholds, from chip_smoke.py's route sweep (phase 15:
# rows 2 to 16,384 over a layer's seven linears of the 1.5B and of the 7B,
# each route timed at every row count; an H100 SXM at 700 W): up to
# GEMV_MAX_ROWS rows the streaming GEMV (csrc/int8_matmul.cu), from
# GEMM_MIN_ROWS the 256-row GEMM (csrc/int8_gemm.cu), between them the
# split-K GEMM (csrc/int8_gemm_splitk.cu). A layer of the 1.5B / the 7B,
# GEMV against split-K: 0.068 / 0.068 ms and 0.152 / 0.158 at 2 rows, 0.073
# / 0.070 and 0.179 / 0.156 at 3, 0.102 / 0.070 and 0.294 / 0.155 at 8. At
# 2 rows the two lie within 1-7% of each other, either way from run to run.
# Split-K against the 256-row GEMM: 0.236 / 0.282 and 0.529 / 0.684 at 512
# rows, 0.692 / 0.738 and 2.867 / 3.291 at 4,096, 1.265 / 1.337 and 6.334 /
# 6.646 at 8,192, 3.765 / 2.689 and 19.53 / 13.58 at 16,384 (whose grid,
# row tiles first, then reads x once a column tile, past what L2 holds).
GEMV_MAX_ROWS = 2
GEMM_MIN_ROWS = 16384
GEMM_TILE = (256, 128)  # its output tile (rows, columns) per block
# The split-K GEMM: its row tiles (the wgmma N, a template parameter of the
# kernel), columns a block, k a step, the row tile up to which two blocks
# share an SM (their accumulators fit in 128 registers a thread), and the
# most f32 partials a segment may write (the workspace stays within the 50
# MB L2).
SK_ROW_TILES = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256)
SK_COLS = 128
SK_KSTEP = 64
SK_TWO_BLOCKS_TO = 128
SK_MAX_PART_FLOATS = 8 << 20
MAX_SEGMENTS = 3
# The streaming GEMV (csrc/weight_stream.cuh), which kernels C and D run on
# too: rows per block (a template parameter there) with the blocks per SM its
# K split aims at, columns per block for int8 weights (8 16-byte vectors: 64
# for bf16, 32 for f32), and the least and most k one block takes (x is
# staged in shared memory). The K axis is split until the grid fills one
# wave of the H100's 132 SMs and no more: a second, partial wave costs as
# much as the first. More rows than a tile run as several row tiles that
# share the weight through L2; the 4-row tile, whose blocks take longer each,
# pays only where the call has the work to fill the card (from
# GEMV_WIDE_TILE_MACS multiply-adds: gate/up from 3 rows, q/o from 14, k/v
# never).
GEMV_ROW_TILES = {1: 4, 2: 4, 4: 2}
GEMV_WIDE_TILE_MACS = 32 << 20
GEMV_COLS = 128
GEMV_MIN_KPS = 128
GEMV_MAX_KPS = 512
SMS = 132


class Int8Plan(NamedTuple):
    """How kernel A covers a (rows, k) @ (k, n) call: its route, the output
    tile of one block, and the K splits (the GEMM never splits K)."""
    route: str  # "gemv" (int8_matmul.cu), "splitk" (int8_gemm_splitk.cu), "gemm" (int8_gemm.cu)
    row_tile: int
    col_tile: int
    splits: int
    k_per_split: int


def _gemv_plan(rows: int, k: int, n: int, wbytes: int = 1) -> tuple[int, int, int]:
    """(rows per block, K splits, k per split) of the streaming GEMV over a
    (k, n) weight of ``wbytes`` bytes an element, from the shapes alone: 1 or
    2 rows a block, or 4 where more than 2 rows bring GEMV_WIDE_TILE_MACS
    multiply-adds (more rows than the tile run as several row tiles), and the
    K axis split into as many slices as fill one wave of blocks, each a
    multiple of 16 k (one k row per k lane) within [GEMV_MIN_KPS,
    GEMV_MAX_KPS]."""
    rt = 1 if rows == 1 else 4 if rows > 2 and rows * k * n >= GEMV_WIDE_TILE_MACS else 2
    tiles = -(-n // (GEMV_COLS // wbytes)) * -(-rows // rt)
    splits = max(1, SMS * GEMV_ROW_TILES[rt] // tiles)
    kps = -(-(-(-k // splits)) // 16) * 16
    kps = min(max(kps, GEMV_MIN_KPS), GEMV_MAX_KPS, -(-k // 16) * 16)
    return rt, -(-k // kps), kps


def _gemv_tiles(rows: int, n: int, rt: int, wbytes: int = 1) -> int:
    """Arrival counters of one streaming launch: its (row tile, column tile)s."""
    return -(-rows // rt) * -(-n // (GEMV_COLS // wbytes))


def _sk_plan(rows: int, k: int, n: int) -> tuple[int, int, int]:
    """(row tile, K splits, k per split) of the split-K GEMM over a (k, n)
    int8 weight, from the shapes alone: the fewest row tiles of at most 256
    rows, each the least of SK_ROW_TILES that holds its share (so the weight
    is read once up to 256 rows), and the K axis split into as many slices
    of whole 64-k steps as keep the grid within one wave of blocks (two an
    SM at row tiles up to SK_TWO_BLOCKS_TO), a segment's f32 partials within
    SK_MAX_PART_FLOATS, and the partials of a tile cheap to add: the one
    block that adds a tile's S partial tiles reads no more bytes than each
    split reads of x and w8 (S^2 x rows x 128 x 4 <= steps x (64 x 128 +
    rows x 64 x 2); with more, 24 splits of one step at 256 rows ran three
    times slower than none)."""
    share = -(-rows // -(-rows // SK_ROW_TILES[-1]))
    bm = next(t for t in SK_ROW_TILES if t >= share)
    tiles = -(-n // SK_COLS) * -(-rows // bm)
    steps = -(-k // SK_KSTEP)
    per_sm = 2 if bm <= SK_TWO_BLOCKS_TO else 1
    sum_cap = math.isqrt(steps * SK_KSTEP * (SK_COLS + 2 * bm) // (bm * SK_COLS * 4))
    splits = max(1, min(SMS * per_sm // tiles, SK_MAX_PART_FLOATS // (rows * n), steps,
                        sum_cap))
    per = -(-steps // splits)
    return bm, -(-steps // per), per * SK_KSTEP


# Kernels C and D on the split-K core (csrc/splitk_core.cuh, where the block
# forms its K slice of x in shared memory and the weight rides alone in a
# ring of SK_LOADED_STAGES tiles: 6 or 8 read 1-13% slower than 4 at C's
# and D's batched rows on an H100): the row tiles they are built for, and
# the most rows they take there, three bf16 terms of f32 activations in one
# 256-row tile (bf16 activations take one term, up to the 96-row tile).
SK_FUSED_TILES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
SK_FUSED_MAX_ROWS = 85
SK_LOADED_STAGES = 4
SK_SMEM_SM, SK_SMEM_BLOCK = 233472, 232448  # shared memory of an SM, the most a block takes


def _sk_x_room(bm: int) -> int:
    """Bytes of a block's x slice at row tile ``bm`` where the block forms x
    (splitk_core.cuh SkTile::LOADED_ROOM less the weight ring, its barriers
    and alignment)."""
    room = (SK_SMEM_SM // 2 - 1024 if bm <= SK_TWO_BLOCKS_TO else SK_SMEM_BLOCK) - 2048
    return room - SK_LOADED_STAGES * (SK_KSTEP * SK_COLS + 16) - 1024


def _sk_fused_plan(rows: int, k: int, n: int, terms: int) -> tuple[int, int, int]:
    """(row tile, K splits, k per split) of one pass of kernel C or D on the
    split-K core over a (k, n) int8 weight, from the shapes alone: the rows'
    ``terms`` bf16 terms stacked on wgmma's N axis (terms x rows of it, one
    tile of SK_FUSED_TILES where they fit 256, so the weight is read once),
    and K split as _sk_plan splits it (one wave, a segment's partials within
    SK_MAX_PART_FLOATS, a tile's partials cheap to add), into more slices
    where a block's slice of x would not fit its shared memory."""
    rn = terms * rows
    if terms > 1 and rn > SK_ROW_TILES[-1]:
        raise ValueError(f"{rows} rows of {terms} terms do not fit one {SK_ROW_TILES[-1]}-row tile")
    share = -(-rn // -(-rn // SK_ROW_TILES[-1]))
    bm = next(t for t in SK_FUSED_TILES if t >= share)
    tiles = -(-n // SK_COLS) * -(-rn // bm)
    steps = -(-k // SK_KSTEP)
    per_sm = 2 if bm <= SK_TWO_BLOCKS_TO else 1
    sum_cap = math.isqrt(steps * SK_KSTEP * (SK_COLS + 2 * bm) // (bm * SK_COLS * 4))
    splits = max(1, min(SMS * per_sm // tiles, SK_MAX_PART_FLOATS // (rn * n), steps, sum_cap))
    per = min(-(-steps // splits), _sk_x_room(bm) // (bm * SK_KSTEP * 2))
    splits = -(-steps // per)
    per = -(-steps // splits)
    return bm, -(-steps // per), per * SK_KSTEP


def split_bf16_terms(x: torch.Tensor, terms: int) -> list:
    """x (f32) as ``terms`` bf16 tensors whose sum gives x back, as the
    split-K core's block-formed x takes f32 values (csrc/splitk_core.cuh
    sk_form_x): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid);
    every subtraction is exact. Three terms hold an f32 value whole (24
    significant bits in 3 x 8) wherever lo stays a normal bf16 (|x| >=
    2^-110) and hi finite (|x| below bf16's largest, 3.39e38)."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return out


def _sk_fused_workspace(rows: int, terms: int, passes) -> tuple[int, int]:
    """(f32 partials, arrival counters) of the widest of a kernel C or D
    call's passes on the split-K core, each ((row tile, splits, kps), N):
    every split writes its (terms x rows, N) partial tile."""
    rn = terms * rows
    return (max(p[1] * rn * n for p, n in passes),
            max(-(-rn // p[0]) * -(-n // SK_COLS) for p, n in passes))


def _route_plan(route: str, rows: int, k: int, n: int) -> Int8Plan:
    """The plan ``route`` takes for a (rows, k) @ (k, n) call."""
    if route == "gemm":
        return Int8Plan("gemm", *GEMM_TILE, 1, k)
    tile, splits, kps = (_gemv_plan if route == "gemv" else _sk_plan)(rows, k, n)
    return Int8Plan(route, tile, GEMV_COLS if route == "gemv" else SK_COLS, splits, kps)


def _route(rows: int) -> str:
    """Kernel A's route by row count alone: the GEMV streams the weight once
    on CUDA cores for the fewest rows, the split-K GEMM reads it once on the
    tensor cores for the middle rows, and from GEMM_MIN_ROWS up the 256-row
    GEMM, which never splits K."""
    return "gemm" if rows >= GEMM_MIN_ROWS else "splitk" if rows > GEMV_MAX_ROWS else "gemv"


def _plan(rows: int, k: int, n: int) -> Int8Plan:
    """Kernel A's plan of a (rows, k) @ (k, n) call: its route's."""
    return _route_plan(_route(rows), rows, k, n)


def _segment_plans(rows: int, k: int, n: int, segments=None, route: str | None = None) -> list:
    """(first column, width, plan) of each segment of a (rows, k) @ (k, n)
    call: every segment gets the plan of its own call (``_plan(rows, k,
    width)``, or the plan of ``route`` where one is named), so its columns
    sum K in the order they would unpacked. ``segments`` (the output widths,
    summing to n; None: one) may hold at most MAX_SEGMENTS widths, each but
    the last a multiple of the 128 columns of a block, so that a boundary
    falls between blocks."""
    widths = (n,) if segments is None else tuple(int(w) for w in segments)
    if not 1 <= len(widths) <= MAX_SEGMENTS or sum(widths) != n or min(widths) <= 0:
        raise ValueError(f"segments {segments} must be 1 to {MAX_SEGMENTS} positive widths "
                         f"summing to OUT={n}")
    if any(w % SK_COLS for w in widths[:-1]):
        raise ValueError(f"segments {segments}: every boundary must fall on a {SK_COLS}-column "
                         "block")
    route = route or _route(rows)
    out, c0 = [], 0
    for w in widths:
        out.append((c0, w, _route_plan(route, rows, k, w)))
        c0 += w
    return out


def _triples(plans: list, cols: int) -> list:
    """The kernels' segment arguments: (first column tile, splits, k per
    split) of each segment, padded with zeros to MAX_SEGMENTS triples."""
    trip = [v for c0, _, p in plans for v in (c0 // cols, p.splits, p.k_per_split)]
    return trip + [0] * (3 * MAX_SEGMENTS - len(trip))


def _part_floats(rows: int, plans: list) -> int:
    """f32 partials of one launch: each segment that splits K writes its
    (splits, rows, width), one segment after another."""
    return sum(p.splits * rows * w for _, w, p in plans if p.splits > 1)


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                segments=None) -> torch.Tensor:
    """y = x @ (w8 * scale) for x (..., IN); the output has x's dtype.
    ``segments``: the output widths of the projections a packed w8 joins
    (``_segment_plans``), each summed as its own call would be.

    Launch counts per route: ``int8_matmul.launches`` (GEMV),
    ``int8_matmul.launches_sk`` (split-K GEMM) and
    ``int8_matmul.launches_tc`` (256-row GEMM)."""
    if x.device.type == "cpu":  # the plain version's sums know no segments
        return int8_matmul_plain(x, w8, scale)
    cin, cout = w8.shape
    x2 = x.reshape(-1, cin).contiguous()
    route = _route(x2.shape[0])
    if route == "gemm":  # no split-K: a column's sum never depends on the others
        _segment_plans(x2.shape[0], cin, cout, segments)
        out = _gemm(x2, w8, scale)
    else:
        out = (_gemv if route == "gemv" else _gemm_splitk)(x2, w8, scale, segments)
    return out.reshape(*x.shape[:-1], cout)


def _check(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Validate a (rows, IN) x against w8 (IN, OUT) and scale; the output."""
    cout = w8.shape[1]
    _cuda.require_cuda(x2, w8, scale)
    if w8.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (cout,):
        raise ValueError(f"expected int8 w8 and f32 scale ({cout},), got {w8.dtype} "
                         f"{tuple(w8.shape)} and {scale.dtype} {tuple(scale.shape)}")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x2.dtype}")
    return torch.empty(x2.shape[0], cout, dtype=x2.dtype, device=x2.device)


def _tma_operands(x2: torch.Tensor, w8: torch.Tensor):
    """x as the tensor-core routes read it by TMA (a 16-byte aligned copy of
    an offset view) and, for f32 x, the bf16 scratch of its cast pass."""
    (rows, cin), cout = x2.shape, w8.shape[1]
    if cin % 8 or cout % 16 or w8.data_ptr() % 16:
        raise ValueError(f"the GEMM's TMA rows must be multiples of 16 bytes: IN={cin} must "
                         f"be a multiple of 8, OUT={cout} of 16, and w8 16-byte aligned")
    if x2.data_ptr() % 16:  # an offset view: TMA reads from 16-byte aligned rows
        x2 = x2.clone()
    xb = torch.empty(rows, cin, dtype=torch.bfloat16, device=x2.device) \
        if x2.dtype == torch.float32 else None
    return x2, xb


def _gemm(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Kernel A's 256-row tensor-core route (csrc/int8_gemm.cu) on (rows, IN) x."""
    out = _check(x2, w8, scale)
    (rows, cin), cout = x2.shape, w8.shape[1]
    if rows == 0:
        return out
    x2, xb = _tma_operands(x2, w8)
    _cuda.library().call(
        "vv_int8_gemm", x2.data_ptr(), _cuda.dtype_code(x2), _cuda.ptr(xb), w8.data_ptr(),
        scale.data_ptr(), out.data_ptr(), rows, cin, cout, _cuda.stream_ptr(x2.device),
    )
    int8_matmul.launches_tc += 1
    return out


_gemv_scratch: dict = {}  # _cuda.workspace_key -> (f32 workspace, int32 zeros)
_gemv_retired: list = []  # outgrown scratch, kept alive for CUDA graphs that captured it


def _gemv_workspace(device: torch.device, n_floats: int, n_tiles: int):
    """The streaming core's f32 workspace (split-K partial sums, and the
    intermediates of kernels C and D behind them) and arrival counters
    (zeros that every launch leaves zero again). Kept per device and grown
    on demand, so a call allocates nothing but its outputs and a launch
    captured in a CUDA graph finds them in place (make one call before
    capturing). Calls of one stream share them in turn; a side stream has
    its own (``_cuda.workspace_key``)."""
    key = _cuda.workspace_key(device)
    ws = _gemv_scratch.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_tiles:
        if ws is not None:
            _gemv_retired.append(ws)
            n_floats, n_tiles = max(n_floats, ws[0].numel()), max(n_tiles, ws[1].numel())
        ws = (torch.empty(max(n_floats, 1 << 20), dtype=torch.float32, device=device),
              torch.zeros(max(n_tiles, 4096), dtype=torch.int32, device=device))
        _gemv_scratch[key] = ws
    return ws


def _gemv(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
          segments=None) -> torch.Tensor:
    """Kernel A's streaming GEMV route (csrc/int8_matmul.cu) on (rows, IN) x:
    one launch, no allocation but the output. Its row tile is the first
    segment's: a row's sum never depends on it (each row is summed alone,
    in the same lanes), only on its segment's K split."""
    out = _check(x2, w8, scale)
    (rows, cin), cout = x2.shape, w8.shape[1]
    if rows == 0:
        return out
    if cout % 16 or w8.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16 int8 columns at once: OUT={cout} must be a "
                         "multiple of 16 and w8 16-byte aligned")
    plans = _segment_plans(rows, cin, cout, segments, "gemv")
    rt, floats = plans[0][2].row_tile, _part_floats(rows, plans)
    part, counters = (None, None) if floats == 0 else _gemv_workspace(
        x2.device, floats, _gemv_tiles(rows, cout, rt))
    _cuda.library().call(
        "vv_int8_matmul", x2.data_ptr(), _cuda.dtype_code(x2), w8.data_ptr(), scale.data_ptr(),
        out.data_ptr(), _cuda.ptr(part), _cuda.ptr(counters), rows, cin, cout, rt,
        *_triples(plans, GEMV_COLS), _cuda.stream_ptr(x2.device),
    )
    int8_matmul.launches += 1
    return out


def _gemm_splitk(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                 segments=None) -> torch.Tensor:
    """Kernel A's split-K tensor-core route (csrc/int8_gemm_splitk.cu) on
    (rows, IN) x: one launch (after a cast pass for f32 x), no allocation
    but the output (and f32 x's bf16 copy); its partials and counters are
    the streaming core's (``_gemv_workspace``)."""
    out = _check(x2, w8, scale)
    (rows, cin), cout = x2.shape, w8.shape[1]
    if rows == 0:
        return out
    x2, xb = _tma_operands(x2, w8)
    plans = _segment_plans(rows, cin, cout, segments, "splitk")
    bm, floats = plans[0][2].row_tile, _part_floats(rows, plans)
    part, counters = (None, None) if floats == 0 else _gemv_workspace(
        x2.device, floats, -(-rows // bm) * -(-cout // SK_COLS))
    _cuda.library().call(
        "vv_int8_gemm_splitk", x2.data_ptr(), _cuda.dtype_code(x2), _cuda.ptr(xb),
        w8.data_ptr(), scale.data_ptr(), out.data_ptr(), _cuda.ptr(part), _cuda.ptr(counters),
        rows, cin, cout, bm, *_triples(plans, SK_COLS), _cuda.stream_ptr(x2.device),
    )
    int8_matmul.launches_sk += 1
    return out


_cuda.count_launches("int8_matmul", int8_matmul)
_cuda.count_launches("int8_matmul_splitk", int8_matmul, "launches_sk")
_cuda.count_launches("int8_matmul_gemm", int8_matmul, "launches_tc")


def int8_matmul_t_plain(g: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E: g * scale rounded to bf16, f32 sum
    against w8^T, output in g's dtype."""
    gs = (g.float() * scale.float()).to(torch.bfloat16).float()
    return torch.matmul(gs, w8.float().t()).to(g.dtype)


DX_CAST, DX_GEMM = 1, 2  # the two phases of csrc/int8_matmul_t.cu


def _dx_launch(g2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, gs: torch.Tensor,
               out: torch.Tensor, phases: int) -> None:
    """Run phases of kernel E on (rows, OUT) g2: DX_CAST forms gs = bf16(g2 *
    scale) with its columns permuted as the GEMM reads them, DX_GEMM writes
    out (rows, IN) from gs. Checks what the kernel takes and raises."""
    cin, cout = w8.shape
    _cuda.require_cuda(g2, w8, scale, gs, out)
    if w8.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (cout,):
        raise ValueError(f"expected int8 w8 and f32 scale ({cout},), got {w8.dtype} "
                         f"{tuple(w8.shape)} and {scale.dtype} {tuple(scale.shape)}")
    if g2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"g must be bf16 or f32, got {g2.dtype}")
    if cout % 16 or cin % 4:
        raise ValueError(f"kernel E reads TMA rows of 16-byte multiples and permutes groups of "
                         f"16 columns: OUT={cout} must be a multiple of 16, and it stores 4 "
                         f"columns at once: IN={cin} a multiple of 4")
    if any(t.data_ptr() % 16 for t in (g2, w8, scale, gs, out)):
        raise ValueError("kernel E reads and writes 16-byte vectors: g, w8, scale and the "
                         "outputs must be 16-byte aligned")
    _cuda.library().call(
        "vv_int8_matmul_t", g2.data_ptr(), _cuda.dtype_code(g2), gs.data_ptr(), w8.data_ptr(),
        scale.data_ptr(), out.data_ptr(), g2.shape[0], cin, cout, phases,
        _cuda.stream_ptr(g2.device),
    )


def int8_matmul_t(g: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dx = g @ (w8 * scale)^T for g (..., OUT); the output has g's dtype.

    On a CUDA tensor: kernel E (csrc/int8_matmul_t.cu), its cast pass and
    its GEMM in one call, counted in ``int8_matmul_t.launches``."""
    if g.device.type == "cpu":
        return int8_matmul_t_plain(g, w8, scale)
    cin, cout = w8.shape
    g2 = g.reshape(-1, cout).contiguous()
    if g2.data_ptr() % 16:  # an offset view: the cast pass reads 16-byte vectors
        g2 = g2.clone()
    rows = g2.shape[0]
    out = torch.empty(rows, cin, dtype=g.dtype, device=g.device)
    if rows:
        gs = torch.empty(rows, cout, dtype=torch.bfloat16, device=g.device)
        _dx_launch(g2, w8, scale, gs, out, DX_CAST | DX_GEMM)
        int8_matmul_t.launches += 1
    return out.reshape(*g.shape[:-1], cin)


_cuda.count_launches("int8_matmul_t", int8_matmul_t)


class Int8MatmulDx(torch.autograd.Function):
    """y = int8_matmul(x, w8, scale, segments) with the gradient w.r.t. x
    only: kernel A forward, kernel E backward. w8 and scale are frozen
    (QLoRA): they get no gradient, and asking for one is not an error."""

    @staticmethod
    def forward(ctx, x, w8, scale, segments=None):
        ctx.save_for_backward(w8, scale)
        return int8_matmul(x, w8, scale, segments)

    @staticmethod
    def backward(ctx, g):
        w8, scale = ctx.saved_tensors
        return int8_matmul_t(g, w8, scale), None, None, None


def _quant_entry(p: Dict) -> Dict:
    """A linear entry with its weight quantized, when both its dims are
    multiples of 512 (the JAX package's rule, kept so that the two packages
    quantize the same layers); smaller or odd layers stay dense."""
    w = p["w"]
    if w.shape[0] % 512 or w.shape[1] % 512:
        return p
    q = dict(p)
    q.update(quantize_weight(q.pop("w")))
    return q


def quantize_diffusion_head(head: Dict) -> Dict:
    """The diffusion head's AdaLN projections and FFN linears int8 (through
    ``_quant_entry``); the embedders, projections and norms stay dense."""
    out = dict(head)
    out["layers"] = [{**layer, "ffn": {k: _quant_entry(v) for k, v in layer["ffn"].items()},
                      "adaln": _quant_entry(layer["adaln"])} for layer in head["layers"]]
    return out


def quantize_tokenizer(tok_params: Dict) -> Dict:
    """The ConvNeXt blocks' FFN linears (fc1, fc2) int8 in every stage of
    the encoder and decoder present; convolutions and norms stay dense."""
    out = dict(tok_params)
    for part in ("encoder", "decoder"):
        if part in tok_params:
            sub = dict(tok_params[part])
            sub["stages"] = [[{**block, "ffn": {name: _quant_entry(block["ffn"][name])
                                                for name in ("fc1", "fc2")}}
                              for block in stage] for stage in sub["stages"]]
            out[part] = sub
    return out


def pack_lm_projections(lm_params: Dict) -> Dict:
    """Each int8 layer's q|k|v as one "qkv" entry and gate|up as one
    "gateup" (w8, scale and the bias concatenated along the output axis;
    a layer without a bias of its own gets zeros there); the originals go,
    so one int8 copy stays on the device. Scales are per column, and
    ``qwen2.project_qkv`` and ``mlp_forward``, which consume the packed
    entries, pass kernel A the unpacked widths as ``segments``, so the
    packed product equals the separate ones column for column, bit for bit.
    Dense (bf16) layers are left as they are."""

    def cat(parts, with_bias: bool) -> Dict:
        p = {"w8": torch.cat([x["w8"] for x in parts], dim=1).contiguous(),
             "scale": torch.cat([x["scale"] for x in parts])}
        if with_bias:
            p["b"] = torch.cat([x["b"] if "b" in x else torch.zeros(
                x["w8"].shape[1], dtype=torch.bfloat16, device=x["w8"].device) for x in parts])
        return p

    out = dict(lm_params)
    layers = []
    for layer in lm_params["layers"]:
        a, m = layer["attn"], layer["mlp"]
        if "w8" not in a["q"]:
            layers.append(layer)
            continue
        attn = {k: v for k, v in a.items() if k not in ("q", "k", "v")}
        attn["qkv"] = cat([a["q"], a["k"], a["v"]], with_bias="b" in a["q"])
        mlp = {k: v for k, v in m.items() if k not in ("gate", "up")}
        mlp["gateup"] = cat([m["gate"], m["up"]], with_bias=False)
        layers.append({**layer, "attn": attn, "mlp": mlp})
    out["layers"] = layers
    return out


def quantize_lm(lm_params: Dict) -> Dict:
    """Quantize the Qwen2 linears in place of their 'w' entries; biases,
    norms and embeddings stay as they are."""
    out = dict(lm_params)
    layers = []
    for layer in lm_params["layers"]:
        nl = {**layer, "attn": dict(layer["attn"]), "mlp": dict(layer["mlp"])}
        for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                p = dict(layer[group][name])
                p.update(quantize_weight(p.pop("w")))
                nl[group][name] = p
        layers.append(nl)
    out["layers"] = layers
    return out


def mm(x: torch.Tensor, p: Dict, segments=None) -> torch.Tensor:
    """Linear apply on a dense ('w') or int8 ('w8' + 'scale') entry, plus bias;
    ``segments`` as ``int8_matmul`` takes them (a packed int8 entry).

    A "lora" entry (A (IN, r), B (r, OUT), scaling), as finetune/lora.py
    attaches it over an int8 base, adds the low-rank branch at run time:
    y += ((x @ A) @ B) * s, so gradients reach A and B while the int8 base
    stays frozen (QLoRA)."""
    if "w8" in p:
        if x.requires_grad and torch.is_grad_enabled():
            y = Int8MatmulDx.apply(x, p["w8"], p["scale"], segments)
        else:
            y = int8_matmul(x, p["w8"], p["scale"], segments)
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    if "lora" in p:
        a, b, s = p["lora"]
        y = y + torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype)) * s
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
