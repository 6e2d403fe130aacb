"""Kernel B: causal GQA attention over the persistent KV cache
(port of vibevoice_tpu/ops/flash_attention.py, cached half).

One function serves chunked prefill (W > 1) and decode (W = 1). Query row i
of sample b sits at absolute slot ``base[b] + i`` and attends keys
``j <= base[b] + i`` (clamped to the cache). Right padding is assumed: pad
rows of a chunk attend like valid rows at their slot, as on the TPU.
int8 caches carry per-row scales (B, KH, 1, S): the K scale multiplies the
scores and the V scale the probabilities.

On a CUDA tensor ``flash_cached_attention`` launches one of two
hand-written kernels: bf16 q with W > 1 (prefill chunks) the tensor-core
flash attention of csrc/flash_prefill.cu (``_prefill_plan`` sizes its grid),
decode (W = 1) and f32 q the one-launch flash-decoding kernel of
csrc/flash_decode.cu, whose key splits come from the shapes
(``_decode_plan``) and divide each row tile's own horizon on the card
(``_decode_split``), so the launch can be captured in a CUDA graph and
replayed with other bases. On a CPU tensor it runs
``flash_cached_attention_plain``.

Kernel F, ``flash_ring_block``, is one hop of ring attention (the JAX
file's ``flash_ring_block``, with ``ring_state_init`` and
``ring_state_out``): it folds a visiting K/V block into an online-softmax
state ``(m, l, acc)`` in f32 that the caller carries across hops, updated in
place. On a CUDA tensor it launches csrc/flash_ring.cu (bf16 at D 128: both
products as wgmma on the tensor cores, P as two bf16 terms so the f32 state
keeps its accuracy; f32 at D 16: CUDA cores), whose tiles ``_ring_plan`` and
``_ring_tile`` describe; on a CPU tensor it runs ``flash_ring_block_plain``.

``flash_train_attention`` is the no-cache causal attention of fine-tuning
(vibevoice_tpu/models/qwen2.py:284 ``_attention_train_flash``, which calls
the Pallas TPU flash attention bundled with JAX). On CUDA tensors it always
takes the hand-written kernels of csrc/flash_train.cu through the autograd
Function ``FlashTrainAttention``: ``flash_train_attention_fwd`` (O and the
row log-sum-exp) and ``flash_train_attention_bwd`` (dQ, dK, dV). Their mask
is the library kernel's: causal within segment ids (valid 1, pad 0). On CPU
tensors it runs ``train_attention_plain``, the JAX masked path
(``_attention_masked`` with the valid & causal mask) under autograd. The two
agree on valid rows; pad rows differ (the kernel's attend pads, the plain
version's attend the valid prefix) and are never read by the training loss.
``_train_plan`` picks the kernels' route from (dtype, D): at D 64 and 128
both products of each pass run as wgmma on the tensor cores, f32 inputs as
a three-term bf16 split (``split_bf16`` is the split's plain version), over
the tile walks of ``_train_walk``; at D 16 and 32 the f32 CUDA-core kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

# csrc/flash_decode.cu: folded query rows w * G + g per block, by q dtype
# (16 for bf16 q on the tensor cores, 8 for f32 q), and the head dims built
DECODE_ROWS = {torch.bfloat16: 16, torch.float32: 8}
DECODE_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (16, 32, 64, 128)}
DECODE_KEYS = 64  # keys per K/V tile there
DECODE_MAX_SPLITS = 132  # its merge holds at most this many splits
PREFILL_ROWS = 64  # folded query rows w * G + g per block of csrc/flash_prefill.cu
PREFILL_KEYS = 64  # keys per K/V tile there
SMS = 132  # streaming multiprocessors of an H100 SXM


def _decode_plan(b: int, w: int, g: int, kh: int, s: int, rows: int) -> tuple[int, int]:
    """(row tiles, key splits) of the decode kernel for B samples, W query
    positions, G query heads per KV head, KH KV heads, an S-slot cache and
    ``rows`` folded rows per block.

    From the shapes alone, never from the bases, so the launch needs no
    sync with the card and a CUDA graph can replay it with other bases:
    the key axis is split until the (sample, KV head, row tile) blocks fill
    two waves of the SMs (two blocks fit on an SM), down to two key tiles of
    the cache per split."""
    tiles = -(-(w * g) // rows)
    blocks = b * kh * tiles
    key_tiles = -(-s // DECODE_KEYS)
    return tiles, max(1, min(-(-2 * SMS // blocks), -(-key_tiles // 2), DECODE_MAX_SPLITS))


def _decode_split(total: int, n_splits: int, sp: int) -> tuple[int, int]:
    """Key tiles [first, end) of split ``sp`` of a row tile whose rows attend
    keys [0, total), as csrc/flash_decode.cu computes them from base on the
    card: the live tiles are shared evenly, at least one per split; splits
    past them are empty and exit without writing."""
    nblk = -(-total // DECODE_KEYS)
    ns = min(n_splits, nblk)
    if sp >= ns:
        return nblk, nblk
    return sp * nblk // ns, (sp + 1) * nblk // ns


_decode_counters: dict = {}  # _cuda.workspace_key -> int32 zeros, one per row tile
_decode_retired: list = []  # outgrown counters, kept alive for CUDA graphs that captured them


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's arrival counters: zeros that every launch leaves
    zero again. Kept per device and grown on demand, so a launch captured in
    a CUDA graph finds them allocated (make one call before capturing); a
    buffer that a larger call outgrows stays allocated, so a graph captured
    before still replays. A side stream has its own
    (``_cuda.workspace_key``)."""
    key = _cuda.workspace_key(device)
    c = _decode_counters.get(key)
    if c is None or c.numel() < n:
        if c is not None:
            _decode_retired.append(c)
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _decode_counters[key] = c
    return c


def _prefill_plan(b: int, w: int, g: int, kh: int, s: int) -> tuple[int, int]:
    """(row tiles, key splits) of the prefill kernel for B samples, W query
    positions, G query heads per KV head, KH KV heads and an S-slot cache.

    Where the (sample, KV head, row tile) blocks fill less than two waves of
    the card's SMs, the key axis is split until they do, keeping at least
    four key tiles of the cache per split."""
    tiles = -(-(w * g) // PREFILL_ROWS)
    blocks = b * kh * tiles
    if blocks >= 2 * SMS:
        return tiles, 1
    return tiles, max(1, min(-(-2 * SMS // blocks), -(-s // PREFILL_KEYS) // 4))


def _prefill_split(total: int, n_splits: int, sp: int) -> tuple[int, int]:
    """Key tiles [first, end) of split ``sp`` of a row tile whose rows attend
    keys [0, total) (csrc/flash_prefill.cu computes the same from base on
    the card): the tile's own horizon is divided evenly, so no split starts
    past it; splits beyond its key-tile count are empty."""
    nblk = -(-total // PREFILL_KEYS)
    ns = min(n_splits, nblk)
    if sp >= ns:
        return nblk, nblk
    return sp * nblk // ns, (sp + 1) * nblk // ns


def flash_cached_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B over the whole cache, f32 softmax."""
    b, w, nh, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    g = nh // kh
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, w, kh, g, d) * scale
    sc = torch.einsum("bwkgd,bksd->bkgws", qg, k_cache.float())
    if k_scale is not None:
        sc = sc * k_scale.float()[:, :, None]  # (B, KH, 1, 1, S)
    lim = base_lens.to(torch.int64)[:, None] + torch.arange(w, device=q.device)  # (B, W)
    live = torch.arange(s, device=q.device)[None, None, :] <= lim[:, :, None]  # (B, W, S)
    sc = sc.masked_fill(~live[:, None, None], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None]
    out = torch.einsum("bkgws,bksd->bwkgd", p, v_cache.float())
    return out.reshape(b, w, nh, d).to(q.dtype)


def flash_cached_attention(
    q: torch.Tensor,  # (B, W, NH, D)
    k_cache: torch.Tensor,  # (B, KH, S, D), the chunk already written at base
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # (B,) int32
    *,
    k_scale: Optional[torch.Tensor] = None,  # (B, KH, 1, S) f32 for int8 caches
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, W, NH, D) in q's dtype.

    Launch counts per route: ``flash_cached_attention.launches`` (the
    flash-decoding kernel) and ``flash_cached_attention.launches_prefill``
    (the tensor-core prefill kernel)."""
    if q.device.type == "cpu":
        return flash_cached_attention_plain(
            q, k_cache, v_cache, base_lens, k_scale=k_scale, v_scale=v_scale, scale=scale
        )
    b, w, nh, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    quant = k_scale is not None
    tensors = [q, k_cache, v_cache, base_lens] + ([k_scale, v_scale] if quant else [])
    _cuda.require_cuda(*tensors)
    if d > 128 or nh % kh or k_cache.shape != (b, kh, s, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if base_lens.dtype != torch.int32 or base_lens.shape != (b,):
        raise ValueError("base_lens must be (B,) int32")
    if quant:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise ValueError("scales given but the cache is not int8")
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != (b, kh, 1, s):
                raise ValueError(f"scales must be (B, KH, 1, S) f32, got {tuple(t.shape)}")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"a {k_cache.dtype} cache needs q of the same dtype, got {q.dtype}")
    scale = float(d ** -0.5 if scale is None else scale)
    r = w * (nh // kh)
    if q.dtype == torch.bfloat16 and w > 1:
        if d not in (64, 128):
            raise ValueError(f"the prefill kernel is built for head_dim 64 and 128, got {d}")
        if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
            raise ValueError("the prefill kernel copies 16-byte chunks: the caches must be "
                             "16-byte aligned")
        if q.data_ptr() % 16:  # an offset view
            q = q.clone()
        _, n_splits = _prefill_plan(b, w, nh // kh, kh, s)
        out = torch.empty_like(q)
        ws = torch.empty(b * kh * n_splits * r * (d + 2) if n_splits > 1 else 0,
                         dtype=torch.float32, device=q.device)
        _cuda.library().call(
            "vv_flash_prefill", q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            _cuda.dtype_code(k_cache), _cuda.ptr(k_scale), _cuda.ptr(v_scale),
            base_lens.data_ptr(), out.data_ptr(), ws.data_ptr(), b, w, nh, kh, s, d, n_splits,
            scale, _cuda.stream_ptr(q.device),
        )
        flash_cached_attention.launches_prefill += 1
        return out
    if q.dtype not in DECODE_ROWS:
        raise ValueError(f"the decode kernel takes bf16 or f32 q, got {q.dtype}")
    if d not in DECODE_HEAD_DIMS[q.dtype]:
        raise ValueError(f"the decode kernel is built for head_dim {DECODE_HEAD_DIMS[q.dtype]} "
                         f"at {q.dtype} q, got {d}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the decode kernel copies 16-byte chunks: the caches must be "
                         "16-byte aligned")
    if quant and (k_scale.data_ptr() % 4 or v_scale.data_ptr() % 4):
        raise ValueError("the decode kernel copies the scales 4 bytes at a time")
    if q.data_ptr() % 16:  # an offset view: bf16 q is copied in 16-byte chunks
        q = q.clone()
    rows = DECODE_ROWS[q.dtype]
    tiles, n_splits = _decode_plan(b, w, nh // kh, kh, s, rows)
    out = torch.empty_like(q)
    part = torch.empty(b * kh * tiles * n_splits * rows * (d + 2) if n_splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    _cuda.library().call(
        "vv_flash_decode", q.data_ptr(), _cuda.dtype_code(q), k_cache.data_ptr(),
        v_cache.data_ptr(), _cuda.dtype_code(k_cache), _cuda.ptr(k_scale), _cuda.ptr(v_scale),
        base_lens.data_ptr(), out.data_ptr(), part.data_ptr(),
        _counters(q.device, b * kh * tiles).data_ptr(), b, w, nh, kh, s, d, n_splits, scale,
        _cuda.stream_ptr(q.device),
    )
    flash_cached_attention.launches += 1
    return out


_cuda.count_launches("flash_cached_attention", flash_cached_attention)
_cuda.count_launches("flash_cached_attention_prefill", flash_cached_attention,
                     "launches_prefill")


# ---------------------------------------------------------------------------
# Ring-attention hop (kernel F)
# ---------------------------------------------------------------------------

RING_M_INIT = -1e30  # m of a row that has seen no live key (the JAX kernel's NEG_INF)


def ring_state_init(b: int, kh: int, r: int, d: int, device=None):
    """Fresh (m, l, acc) for ``flash_ring_block``: m and l (B, KH, R), acc
    (B, KH, R, D), all f32. R = W * G folded query rows, row w * G + g being
    query head kh * G + g of position w."""
    return (torch.full((b, kh, r), RING_M_INIT, dtype=torch.float32, device=device),
            torch.zeros((b, kh, r), dtype=torch.float32, device=device),
            torch.zeros((b, kh, r, d), dtype=torch.float32, device=device))


def _fold_heads(x: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, W, NH, D) -> (B, KH, W * G, D) with row w * G + g."""
    b, w, nh, d = x.shape
    return x.reshape(b, w, kh, nh // kh, d).transpose(1, 2).reshape(b, kh, -1, d)


def flash_ring_block_plain(state, q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, *,
                           q_start: int, k_start: int, k_len: torch.Tensor,
                           scale: Optional[float] = None, q_chunk: int = 512):
    """Plain PyTorch version of kernel F, in f32, over ``q_chunk`` query
    positions at a time (the score tile is (B, KH, q_chunk * G, S)).

    A row with no live key in the block keeps its state exactly. So does a
    row that has seen no live key yet, whose l and acc stay 0 where the TPU
    kernel accumulates a placeholder that its first live key wipes (the
    outputs agree on every row that sees a key)."""
    m, l, acc = state
    b, w, nh, d = q.shape
    kh, s = k_blk.shape[1], k_blk.shape[2]
    g = nh // kh
    scale = d ** -0.5 if scale is None else scale
    qg = _fold_heads(q.float(), kh) * scale
    kf, vf = k_blk.float(), v_blk.float()
    k_pos = k_start + torch.arange(s, device=q.device)
    k_lim = int(k_len.max()) - k_start
    for w0 in range(0, w, q_chunk):
        w1 = min(w, w0 + q_chunk)
        kend = min(s, q_start + w1 - k_start, k_lim)  # keys past the chunk's horizon are dead
        if kend <= 0:
            continue
        rows = slice(w0 * g, w1 * g)
        sc = torch.einsum("bkrd,bksd->bkrs", qg[:, :, rows], kf[:, :, :kend])
        row_pos = q_start + torch.arange(w0 * g, w1 * g, device=q.device) // g
        live = ((k_pos[None, None, :kend] <= row_pos[None, :, None])
                & (k_pos[None, None, :kend] < k_len.to(torch.int64)[:, None, None]))
        sc = sc.masked_fill(~live[:, None], float("-inf"))
        m_prev = m[:, :, rows]
        m_new = torch.maximum(m_prev, sc.amax(dim=-1))  # finite: m starts at RING_M_INIT
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[:, :, rows] = l[:, :, rows] * corr + p.sum(dim=-1)
        acc[:, :, rows] = acc[:, :, rows] * corr[..., None] + p @ vf[:, :, :kend]
        m[:, :, rows] = m_new
    return state


# csrc/flash_ring.cu: folded query rows w * G + g per block (one warpgroup
# on the tensor cores, a 16 x 16 thread grid on the CUDA cores) and keys per
# K/V tile
RING_ROWS = 64
RING_KEYS = 64


def _ring_plan(w: int, g: int) -> tuple[int, int]:
    """(folded rows per block, row tiles) of kernel F for W query positions
    and G query heads per KV head."""
    return RING_ROWS, -(-(w * g) // RING_ROWS)


def _ring_tile(tile: int, rows: int, w: int, g: int, s: int, q_start: int, k_start: int,
               k_len: int) -> tuple[int, int, int]:
    """(first folded row, key horizon, unmasked key tiles) of row tile
    ``tile`` of one sample, as csrc/flash_ring.cu computes them on the card:
    the tile reads keys [0, horizon) of the S-key block, up to its last
    row's slot and below k_len (a horizon of 0: the tile lies wholly before
    the block and exits without reading or writing); its first ``unmasked``
    key tiles lie below every row's horizon and skip the mask."""
    row0 = tile * rows
    last_row = min(row0 + rows, w * g) - 1
    klen = k_len - k_start
    horizon = max(0, min(s, q_start + last_row // g + 1 - k_start, klen))
    lim_min = min(q_start + row0 // g - k_start, min(klen, s) - 1)
    return row0, horizon, max(0, (lim_min + 1) // RING_KEYS)


def flash_ring_block(state, q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, *,
                     q_start: int, k_start: int, k_len: torch.Tensor,
                     scale: Optional[float] = None):
    """One ring hop, updating ``state`` = (m, l, acc) in place and returning it.

    q (B, W, NH, D) is the local query shard, its row w at absolute slot
    ``q_start + w``; k_blk/v_blk (B, KH, S, D) the visiting block, its key j
    at slot ``k_start + j``; k_len (B,) int32. Query row i attends key j iff
    ``k_start + j <= q_start + i`` and ``k_start + j < k_len[b]``. q, K and V
    share one dtype; the state is f32 (``ring_state_init``). The kernel is
    built for bf16 at D 128 (the 1.5B model) and f32 at D 16 (the tiny
    config)."""
    if q.device.type == "cpu":
        return flash_ring_block_plain(state, q, k_blk, v_blk, q_start=q_start, k_start=k_start,
                                      k_len=k_len, scale=scale)
    m, l, acc = state
    _cuda.require_cuda(q, k_blk, v_blk, k_len, m, l, acc)
    b, w, nh, d = q.shape
    kh, s = k_blk.shape[1], k_blk.shape[2]
    if nh % kh or k_blk.shape != (b, kh, s, d) or v_blk.shape != k_blk.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, K/V block {tuple(k_blk.shape)}, "
                         f"{tuple(v_blk.shape)}")
    if (q.dtype, d) not in ((torch.bfloat16, 128), (torch.float32, 16)) \
            or k_blk.dtype != q.dtype or v_blk.dtype != q.dtype:
        raise ValueError(f"q, K, V must share one dtype, bf16 at D 128 or f32 at D 16; got "
                         f"{q.dtype}, {k_blk.dtype}, {v_blk.dtype} at D {d}")
    r = w * (nh // kh)
    for t, shape in ((m, (b, kh, r)), (l, (b, kh, r)), (acc, (b, kh, r, d))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"state tensor must be {shape} f32, got {t.dtype} {tuple(t.shape)}")
    if k_len.dtype != torch.int32 or k_len.shape != (b,):
        raise ValueError("k_len must be (B,) int32")
    if q.dtype == torch.bfloat16:
        if k_blk.data_ptr() % 16 or v_blk.data_ptr() % 16 or acc.data_ptr() % 8:
            raise ValueError("the tensor-core kernel copies K and V in 16-byte chunks and the "
                             "state in 8-byte pairs: they must be aligned so")
        if q.data_ptr() % 16:  # an offset view
            q = q.clone()
    rows, _ = _ring_plan(w, nh // kh)
    _cuda.library().call(
        "vv_flash_ring_block", q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), k_len.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), _cuda.dtype_code(q), b, w, nh, kh, s, d, rows,
        int(q_start), int(k_start), float(d ** -0.5 if scale is None else scale),
        _cuda.stream_ptr(q.device),
    )
    flash_ring_block.launches += 1
    return state


_cuda.count_launches("flash_ring_block", flash_ring_block)


def ring_state_out(state, w: int, dtype) -> torch.Tensor:
    """Normalise the carried state into the (B, W, NH, D) attention output."""
    _, l, acc = state
    b, kh, r, d = acc.shape
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, kh, w, r // w, d).transpose(1, 2).reshape(b, w, -1, d).to(dtype)


# ---------------------------------------------------------------------------
# Training (no-cache) attention
# ---------------------------------------------------------------------------


def train_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q (B, T, NH, D), k/v (B, T, KH, D), valid (B, T) bool -> (B, T, NH, D).

    The masked path of the JAX package: key j is live for query i iff
    valid[j] and j <= i; GQA by grouping the query heads; f32 scores and
    softmax, masked scores at the f32 minimum."""
    b, t, nh, d = q.shape
    kh = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, t, kh, nh // kh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    mask = valid[:, None, :] & causal[None]  # (B, T, S)
    scores = scores.masked_fill(~mask[:, None, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(b, t, nh, d)


# csrc/flash_train.cu: the route by head dim, and the query rows or keys per
# tile of the tensor-core route
TRAIN_ROUTES = {64: "wgmma", 128: "wgmma", 16: "cuda_cores", 32: "cuda_cores"}
TRAIN_TILE = 64


def _train_plan(dtype: torch.dtype, d: int) -> str:
    """The route of csrc/flash_train.cu for q, k, v of ``dtype`` at head dim
    D, from the shapes alone: "wgmma" (tensor cores; f32 as a three-term
    bf16 split, bf16 as one term) at D 64 and 128, the 1.5B/7B and 0.5B
    models; "cuda_cores" (f32 arithmetic) at D 16 and 32, the test configs.
    Anything else raises: no route stands in for another."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the training attention takes f32 or bf16, got {dtype}")
    if d not in TRAIN_ROUTES:
        raise ValueError(f"the training attention is built for head_dim {sorted(TRAIN_ROUTES)}, "
                         f"got {d}")
    return TRAIN_ROUTES[d]


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split pass (csrc/flash_train.cu
    flash_train_split): f32 x -> (hi, lo) bf16 with hi = bf16(x) and
    lo = bf16(x - hi), so hi + lo is x within 2^-16 of |x|."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _seg_bounds(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first, last), each (B, T) int64: the first and the last position of
    sample b whose segment id is seg[b, i]. Any int32 ids, runs or not."""
    b, t = seg.shape
    sv, si = torch.sort(seg, dim=1, stable=True)  # equal ids keep their order
    idx = torch.arange(t, device=seg.device).expand(b, t)
    start = torch.ones_like(sv, dtype=torch.bool)
    start[:, 1:] = sv[:, 1:] != sv[:, :-1]
    end = torch.ones_like(start)
    end[:, :-1] = start[:, 1:]
    start_pos = torch.where(start, idx, 0).cummax(1).values
    end_pos = torch.where(end, idx, t - 1).flip(1).cummin(1).values.flip(1)
    first = torch.empty_like(si).scatter_(1, si, si.gather(1, start_pos))
    last = torch.empty_like(si).scatter_(1, si, si.gather(1, end_pos))
    return first, last


def _train_walk_plain(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the walk kernel (csrc/flash_train.cu
    flash_train_walk): see ``_train_walk``."""
    b, t = seg.shape
    nt = -(-t // TRAIN_TILE)
    first, last = _seg_bounds(seg)
    pad = nt * TRAIN_TILE - t  # rows past T: no bound of their own
    first = torch.nn.functional.pad(first, (0, pad), value=t).view(b, nt, TRAIN_TILE)
    last = torch.nn.functional.pad(last, (0, pad), value=-1).view(b, nt, TRAIN_TILE)
    return ((first.amin(-1) // TRAIN_TILE).to(torch.int32).contiguous(),
            (last.amax(-1) // TRAIN_TILE).to(torch.int32).contiguous())


def _train_walk(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(kfirst, qlast), each (B, ceil(T / 64)) int32, the tile walks of the
    tensor-core route: query tile i reads key tiles kfirst[i] .. i (the
    first tile holding a key of one of its rows' segments, up to the
    diagonal) in the forward and dQ kernels; key tile j reads query tiles
    j .. qlast[j] (from the diagonal to the last tile holding a query of one
    of its keys' segments) in the dK/dV kernel. On a CUDA tensor one launch
    of the walk kernel; on a CPU tensor its plain version."""
    if seg.device.type == "cpu":
        return _train_walk_plain(seg)
    b, t = seg.shape
    out = torch.empty(2, b, -(-t // TRAIN_TILE), dtype=torch.int32, device=seg.device)
    _cuda.library().call("vv_flash_train_walk", seg.data_ptr(), out[0].data_ptr(),
                         out[1].data_ptr(), b, t, _cuda.stream_ptr(seg.device))
    return out[0], out[1]


def _check_train(q, k, v, seg) -> str:
    _cuda.require_cuda(q, k, v, seg)
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one shape (B, T, H, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if seg.dtype != torch.int32 or seg.shape != (b, t):
        raise ValueError(f"segment ids must be (B, T) int32, got {seg.dtype} {tuple(seg.shape)}")
    return _train_plan(q.dtype, d)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 16 == 0 else x.clone()  # an offset view


def _train_operands(*xs: torch.Tensor):
    """The tensor-core route's bf16 operands of same-shaped tensors: the
    pointers (hi, lo) of each and what holds them. f32: the split pass
    (csrc/flash_train.cu flash_train_split, one launch) into one workspace;
    bf16: the tensor itself and a null lo (one term)."""
    keep = [_aligned16(x) for x in xs]
    if xs[0].dtype == torch.bfloat16:
        return [p for x in keep for p in (x.data_ptr(), None)], keep
    ws =torch.empty((len(xs), 2) + tuple(xs[0].shape), dtype=torch.bfloat16, device=xs[0].device)
    ptrs = [x.data_ptr() for x in keep] + [None] * (4 - len(keep))
    _cuda.library().call("vv_flash_train_split", *ptrs, ws.data_ptr(), len(xs), xs[0].numel(),
                         _cuda.stream_ptr(xs[0].device))
    return [ws[i, j].data_ptr() for i in range(len(xs)) for j in (0, 1)], (ws, keep)


def flash_train_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              seg: torch.Tensor, scale: float):
    """Forward kernel: q, k, v (B, T, H, D) contiguous CUDA tensors of one
    dtype (f32 or bf16), seg (B, T) int32 -> (O (B, T, H, D), LSE (B, H, T) f32).

    Launch counts per route (``_train_plan``): ``launches`` (tensor cores,
    the split pass included) and ``launches_cores`` (CUDA cores)."""
    route = _check_train(q, k, v, seg)
    b, t, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    if route == "cuda_cores":
        _cuda.library().call(
            "vv_flash_train_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _cuda.dtype_code(q), b, t, h, d, float(scale),
            _cuda.stream_ptr(q.device),
        )
        flash_train_attention_fwd.launches_cores += 1
        return o, lse
    kfirst, _ = _train_walk(seg)
    ptrs, _keep = _train_operands(q, k, v)
    _cuda.library().call(
        "vv_flash_train_fwd_tc", *ptrs, seg.data_ptr(), kfirst.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _cuda.dtype_code(q), b, t, h, d, float(scale), _cuda.stream_ptr(q.device),
    )
    flash_train_attention_fwd.launches += 1
    return o, lse


_cuda.count_launches("flash_train_attention_fwd", flash_train_attention_fwd)
_cuda.count_launches("flash_train_attention_fwd_cores", flash_train_attention_fwd,
                     "launches_cores")


def flash_train_attention_bwd(q, k, v, seg, o, lse, do, scale: float):
    """Backward kernels (delta = rowsum(dO * O), then dK/dV per key tile and
    dQ per query tile) -> (dq, dk, dv) in q's dtype. Launch counts per route
    as for the forward."""
    route = _check_train(q, k, v, seg)
    do = do.contiguous()
    _cuda.require_cuda(o, lse, do)
    b, t, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    lib, stream = _cuda.library(), _cuda.stream_ptr(q.device)
    if route == "cuda_cores":
        lib.call(
            "vv_flash_train_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _cuda.dtype_code(q), b, t, h, d, float(scale), stream,
        )
        flash_train_attention_bwd.launches_cores += 1
        return dq, dk, dv
    kfirst, qlast = _train_walk(seg)
    ptrs, _keep = _train_operands(q, k, v)
    if q.dtype == torch.float32:  # dO's split is written by the delta kernel
        do_split = torch.empty((2,) + tuple(do.shape), dtype=torch.bfloat16, device=do.device)
        dh, dl = do_split[0].data_ptr(), do_split[1].data_ptr()
    else:
        do = _aligned16(do)
        dh, dl = do.data_ptr(), None
    lib.call(
        "vv_flash_train_bwd_tc", *ptrs, seg.data_ptr(), kfirst.data_ptr(), qlast.data_ptr(),
        o.data_ptr(), do.data_ptr(), dh, dl, lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _cuda.dtype_code(q), b, t, h, d, float(scale), stream,
    )
    flash_train_attention_bwd.launches += 1
    return dq, dk, dv


_cuda.count_launches("flash_train_attention_bwd", flash_train_attention_bwd)
_cuda.count_launches("flash_train_attention_bwd_cores", flash_train_attention_bwd,
                     "launches_cores")


class FlashTrainAttention(torch.autograd.Function):
    """Training attention on the card: forward and backward are the
    hand-written kernels; q, k, v have the same heads (GQA repeated)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale):
        o, lse = flash_train_attention_fwd(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_train_attention_bwd(q, k, v, seg, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of a right-padded batch without a cache.
    q (B, T, NH, D), k/v (B, T, KH, D), valid (B, T) bool -> (B, T, NH, D).
    Differentiable on both routes."""
    if q.device.type == "cpu":
        return train_attention_plain(q, k, v, valid, scale)
    nh, kh, d = q.shape[2], k.shape[2], q.shape[3]
    if nh % kh:
        raise ValueError(f"{nh} query heads do not group over {kh} KV heads")
    if nh != kh:  # GQA: K/V repeated to the query heads; autograd sums the group
        k = k.repeat_interleave(nh // kh, dim=2)
        v = v.repeat_interleave(nh // kh, dim=2)
    seg = valid.to(torch.int32).contiguous()
    return FlashTrainAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), seg,
                                     float(d ** -0.5 if scale is None else scale))
