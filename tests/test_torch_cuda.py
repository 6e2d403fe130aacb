"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and nvcc (the kernels build at first use) and skip
elsewhere. Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda

Float32 activations: the kernels and the plain versions differ only in
summation order (1e-4 of the peak); bf16 outputs by one bf16 rounding of
the result (1e-2 of the peak).
"""

import numpy as np
import pytest
import torch

from vibevoice_tpu_torch.ops import _cuda
from vibevoice_tpu_torch.ops import flash_attention as fa
from vibevoice_tpu_torch.ops import head_fused as hf
from vibevoice_tpu_torch.ops import quant
from vibevoice_tpu_torch.ops import vocoder_fused as vf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("rows,k,n,dtype", [(2, 256, 96, torch.bfloat16), (19, 320, 1024, torch.float32)])
def test_int8_matmul(dev, rows, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev))
    x = torch.randn(rows, k, generator=g, device=dev).to(dtype)
    out = quant.int8_matmul(x, q["w8"], q["scale"])
    ref = quant.int8_matmul_plain(x, q["w8"], q["scale"])
    assert _rel(out, ref) < (1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(1536, 8960), (8960, 1536), (1536, 256), (200, 208), (1000, 1040)])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 7, 8, 11, 39])
def test_int8_matmul_gemv_route(dev, rows, k, n, dtype):
    """Kernel A's streaming GEMV at every templated row count (1, 2, 4), at
    rows between them and over several row tiles (7, 8, 11, 39), at 1.5B
    decode shapes, at ragged N (a multiple of 16 that is not a multiple of
    the 128-column tile) and K that is not a multiple of the split: within
    1e-2 (bf16 out) / 1e-5 (f32: the same products in another order) of the
    peak of the plain version, one launch a call, and a second call gives
    the same bits."""
    assert rows < quant.GEMM_MIN_ROWS
    g = torch.Generator(device=dev).manual_seed(20)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(rows, k, generator=g, device=dev).to(dtype)
    before = quant.int8_matmul.launches
    out = quant.int8_matmul(x, q["w8"], q["scale"])
    assert quant.int8_matmul.launches == before + 1
    assert out.dtype == dtype and out.shape == (rows, n)
    assert _rel(out, quant.int8_matmul_plain(x, q["w8"], q["scale"])) < (
        1e-2 if dtype == torch.bfloat16 else 1e-5)
    for _ in range(3):
        assert torch.equal(quant.int8_matmul(x, q["w8"], q["scale"]), out)


@pytest.mark.parametrize("k,n", [(1536, 8960), (8960, 1536)])
def test_int8_matmul_gemv_graph_replay(dev, k, n):
    """One capture of the GEMV call in a CUDA graph, replayed with new x
    written in place: the plan comes from the shapes, the workspace and the
    counters persist (and the counters reset themselves), so every replay
    matches the plain version and nothing is allocated but the output."""
    g = torch.Generator(device=dev).manual_seed(21)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(2, k, generator=g, device=dev).to(torch.bfloat16)
    quant.int8_matmul(x, q["w8"], q["scale"])  # the workspace, outside the capture
    torch.cuda.synchronize()
    ws = quant._gemv_scratch[x.device]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant.int8_matmul(x, q["w8"], q["scale"])
    assert quant._gemv_scratch[x.device] is ws
    for _ in range(3):
        x.copy_(torch.randn(2, k, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(out, quant.int8_matmul_plain(x, q["w8"], q["scale"])) < 1e-2
    assert int(ws[1].abs().max()) == 0


def test_int8_matmul_gemv_raises_on_unsupported_input(dev):
    """OUT not a multiple of 16, a w8 that is not 16-byte aligned, f16 x: the
    GEMV wrapper raises."""
    x = torch.randn(2, 64, device=dev)
    q = quant.quantize_weight(torch.randn(64, 40, device=dev))  # 40 columns
    with pytest.raises(ValueError):
        quant.int8_matmul(x, q["w8"], q["scale"])
    q = quant.quantize_weight(torch.randn(64, 64, device=dev))
    flat = torch.zeros(64 * 64 + 4, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # contiguous, 4 bytes off a 16-byte boundary
        quant.int8_matmul(x, flat[4:].view(64, 64), q["scale"])
    with pytest.raises(ValueError):
        quant.int8_matmul(x.half(), q["w8"], q["scale"])


def test_nucleus_tie_order_card_matches_cpu(dev):
    """Top-p sampling where the whole vocabulary ties (the layout of
    tests/test_torch_generate.py's tie-order test: an lm_head of equal
    columns, top_p 0.5, speech_start the one surviving candidate): the
    port on the card picks the tokens the port picks on the CPU, which that
    test holds against the JAX package. The card's unstable sort is another
    algorithm than the CPU's; _choose_tokens sorts with stable=True."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    hop = cfg.acoustic_tokenizer_config.hop_length
    v, h = cfg.decoder_config.vocab_size, cfg.decoder_config.hidden_size
    tok = dict(speech_start=3, speech_end=v - 3, speech_diffusion=v - 2, eos=v - 1)
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6], ids[0, -1] = tok["speech_diffusion"], tok["speech_start"]
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    d, e = tok["speech_diffusion"], tok["eos"]
    kw = dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * hop).astype(np.float32),
              speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask,
              noise_bank={"init": rng.randn(16, 1, cfg.acoustic_vae_dim).astype(np.float32),
                          "vae_std": rng.randn(1).astype(np.float32),
                          "vae_eps": rng.randn(1, 4, cfg.acoustic_vae_dim).astype(np.float32)},
              forced_tokens=np.array([d, d, -1, d, -1, d, e], np.int64)[:, None],
              tokens=inf.SpecialTokens(**tok), seed=0,
              opts=inf.GenerateOptions(ddpm_steps=2, max_length=64, do_sample=True, top_p=0.5))
    params = init(cfg, seed=0, device="cpu")
    params["lm_head"] = torch.zeros(v, h)
    params["lm_head"][:, 0] = 0.5
    seqs = [inf.generate(cfg, _to(params, where), **kw).sequences for where in (dev, "cpu")]
    np.testing.assert_array_equal(seqs[0][0, 12:][[2, 4]], [tok["speech_start"]] * 2)
    np.testing.assert_array_equal(seqs[0], seqs[1])


@pytest.mark.parametrize("w,int8,dtype", [(1, False, torch.bfloat16), (1, True, torch.float32),
                                          (7, True, torch.bfloat16), (7, False, torch.float32)])
def test_flash_cached_attention(dev, w, int8, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    b, nh, kh, s, d = 3, 6, 2, 640, 64
    q = torch.randn(b, w, nh, d, generator=g, device=dev).to(dtype)
    base = torch.tensor([0, 300, s - 1], dtype=torch.int32, device=dev)
    if int8:
        kc = torch.randint(-127, 128, (b, kh, s, d), generator=g, device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (b, kh, s, d), generator=g, device=dev).to(torch.int8)
        kw = dict(k_scale=torch.rand(b, kh, 1, s, generator=g, device=dev) / 127,
                  v_scale=torch.rand(b, kh, 1, s, generator=g, device=dev) / 127)
    else:
        kc = torch.randn(b, kh, s, d, generator=g, device=dev).to(dtype)
        vc = torch.randn(b, kh, s, d, generator=g, device=dev).to(dtype)
        kw = {}
    out = fa.flash_cached_attention(q, kc, vc, base, **kw)
    ref = fa.flash_cached_attention_plain(q, kc, vc, base, **kw)
    assert _rel(out, ref) < (1e-2 if dtype == torch.bfloat16 else 1e-4)


def _head_inputs(dev, seed, nb, dim, hid, rows, quantize, dtype=torch.float32, wdtype=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    layers = [{"norm": {"w": rn(dim)},
               "ffn": {"gate": {"w": rn(dim, hid) / dim ** 0.5},
                       "up": {"w": rn(dim, hid) / dim ** 0.5},
                       "down": {"w": rn(hid, dim) / hid ** 0.5}}} for _ in range(nb)]
    packed = hf.pack_head_ffns(layers, 1e-5, quantize)
    if wdtype is not None:  # dense weights in another dtype
        packed.arrays["wgu"], packed.arrays["wd"] = (packed["wgu"].to(wdtype),
                                                     packed["wd"].to(wdtype))
    return packed, rn(rows, dim).to(dtype), (rn(nb, rows, 3 * dim) * 0.5).to(dtype)


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_head_ffn_stack(dev, quantize):
    packed, x, mods = _head_inputs(dev, 2, 3, 128, 384, 2, quantize)
    assert _rel(hf.fused_head_ffn_stack(packed, x, mods),
                hf.fused_head_ffn_stack_plain(packed, x, mods)) < 1e-4


@pytest.mark.parametrize("dtype,quantize,wdtype", [
    (torch.float32, True, None), (torch.float32, False, None),
    (torch.float32, False, torch.bfloat16), (torch.bfloat16, True, None),
    (torch.bfloat16, False, torch.bfloat16)])
@pytest.mark.parametrize("nb,dim,hid,rows", [(4, 1536, 4608, 2), (4, 1536, 4608, 3),
                                             (2, 64, 192, 2)])
def test_fused_head_ffn_stack_widths(dev, nb, dim, hid, rows, quantize, dtype, wdtype):
    """Kernel C at the 1.5B head's widths (2 rows at bs1 with CFG; 3 rows
    take the other row tile) and tiny_config's, at each (activation, weight)
    dtype pair it takes (int8, or dense f32 / bf16): one launch counted a
    call, within 1e-4 (f32) / 2e-2 (bf16) of the peak of the plain version,
    and three more calls give the same bits (no float atomics; the counters
    reset)."""
    packed, x, mods = _head_inputs(dev, 30, nb, dim, hid, rows, quantize, dtype, wdtype)
    before = hf.fused_head_ffn_stack.launches
    out = hf.fused_head_ffn_stack(packed, x, mods)
    assert hf.fused_head_ffn_stack.launches == before + 1
    assert out.dtype == dtype and out.shape == (rows, dim)
    assert _rel(out, hf.fused_head_ffn_stack_plain(packed, x, mods)) < (
        1e-4 if dtype == torch.float32 else 2e-2)
    for _ in range(3):
        assert torch.equal(hf.fused_head_ffn_stack(packed, x, mods), out)


def _stage_inputs(dev, seed, nb, dim, b, quantize, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    blocks = [{"norm": {"w": rn(dim)}, "mixer": {"w": rn(dim, 1, 7) * 0.3, "b": rn(dim) * 0.1},
               "gamma": torch.full((dim,), 0.5, device=dev), "ffn_norm": {"w": rn(dim)},
               "ffn": {"fc1": {"w": rn(dim, 4 * dim) / dim ** 0.5, "b": rn(4 * dim) * 0.1},
                       "fc2": {"w": rn(4 * dim, dim) / (4 * dim) ** 0.5, "b": rn(dim) * 0.1}},
               "ffn_gamma": torch.full((dim,), 0.5, device=dev)} for _ in range(nb)]
    packed = vf.pack_stage(blocks, 1e-5, quantize)
    if not quantize:  # dense weights in the activation dtype
        packed.arrays["w1"], packed.arrays["w2"] = (packed["w1"].to(dtype), packed["w2"].to(dtype))
    return packed, rn(b, 1, dim).to(dtype), rn(nb, b, 6, dim).to(dtype)


@pytest.mark.parametrize("quantize,dtype", [(False, torch.float32), (True, torch.bfloat16)])
def test_fused_stage_step(dev, quantize, dtype):
    packed, x, st = _stage_inputs(dev, 3, 2, 64, 2, quantize, dtype)
    (y, ns), (yr, nsr) = vf.fused_stage_step(packed, x, st), vf.fused_stage_step_plain(packed, x, st)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel(y, yr) < tol and _rel(ns, nsr) < tol


@pytest.mark.parametrize("quantize,dtype", [(True, torch.bfloat16), (False, torch.bfloat16),
                                            (True, torch.float32), (False, torch.float32)])
@pytest.mark.parametrize("nb,dim,b", [(8, 2048, 1), (8, 2048, 2), (2, 16, 1)])
def test_fused_stage_step_widths(dev, nb, dim, b, quantize, dtype):
    """Kernel D at the 1.5B vocoder stage's widths (one frame a sample, 1 or
    2 samples) and tiny_config's, each (activation, weight) dtype pair it
    takes: one launch counted a call, y and the new state within 1e-4 (f32)
    / 2e-2 (bf16) of the peak of the plain version, and three more calls
    give the same bits."""
    packed, x, st = _stage_inputs(dev, 31, nb, dim, b, quantize, dtype)
    before = vf.fused_stage_step.launches
    y, ns = vf.fused_stage_step(packed, x, st)
    assert vf.fused_stage_step.launches == before + 1
    yr, nsr = vf.fused_stage_step_plain(packed, x, st)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel(y, yr) < tol and _rel(ns, nsr) < tol
    for _ in range(3):
        y2, ns2 = vf.fused_stage_step(packed, x, st)
        assert torch.equal(y2, y) and torch.equal(ns2, ns)


def test_fused_head_and_stage_graph_replay(dev):
    """One capture of a kernel C call and of a kernel D call in a CUDA graph
    (1.5B widths, int8), replayed with new x, mods and states written in
    place: the plans come from the shapes, the workspace persists and the
    counters reset themselves, so every replay matches the plain version and
    no call allocates but its outputs."""
    packed_c, x, mods = _head_inputs(dev, 32, 4, 1536, 4608, 2, True)
    packed_d, xd, st = _stage_inputs(dev, 33, 8, 2048, 1, True, torch.bfloat16)
    hf.fused_head_ffn_stack(packed_c, x, mods)  # the workspace, outside the capture
    vf.fused_stage_step(packed_d, xd, st)
    torch.cuda.synchronize()
    ws = quant._gemv_scratch[x.device]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = hf.fused_head_ffn_stack(packed_c, x, mods)
        yd, ns = vf.fused_stage_step(packed_d, xd, st)
    assert quant._gemv_scratch[x.device] is ws
    g = torch.Generator(device=dev).manual_seed(34)
    for _ in range(3):
        for t in (x, mods, xd, st):
            t.copy_(torch.randn(t.shape, generator=g, device=dev) * (0.5 if t is mods else 1))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(y, hf.fused_head_ffn_stack_plain(packed_c, x, mods)) < 1e-4
        yr, nsr = vf.fused_stage_step_plain(packed_d, xd, st)
        assert _rel(yd, yr) < 2e-2 and _rel(ns, nsr) < 2e-2
    assert int(ws[1].abs().max()) == 0


def test_fused_head_and_stage_raise_on_ragged_widths(dev):
    """Widths that are not multiples of 16 (a 16-byte vector of columns
    would straddle two rows): kernels C and D refuse them on the card."""
    packed, x, mods = _head_inputs(dev, 35, 1, 72, 200, 2, True)
    with pytest.raises(ValueError, match="multiples of 16"):
        hf.fused_head_ffn_stack(packed, x, mods)
    packed, x, st = _stage_inputs(dev, 36, 1, 24, 1, True, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        vf.fused_stage_step(packed, x, st)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [256, 1536, 8960])
@pytest.mark.parametrize("rows", [65, 129, 1000])
def test_int8_matmul_gemm_route(dev, rows, n, dtype):
    """Kernel A's tensor-core route at ragged rows (not a multiple of its
    256-row tile) and the 1.5B's column counts, against the plain version:
    one bf16 rounding of the output (1e-2 of the peak), or for f32 x the same
    bf16 products summed in another order (1e-5)."""
    g = torch.Generator(device=dev).manual_seed(10)
    k = 8960 if n == 1536 else 1536
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(rows, k, generator=g, device=dev).to(dtype)
    before = quant.int8_matmul.launches_tc
    out = quant.int8_matmul(x, q["w8"], q["scale"])
    assert quant.int8_matmul.launches_tc == before + 1
    assert out.dtype == dtype and out.shape == (rows, n)
    assert _rel(out, quant.int8_matmul_plain(x, q["w8"], q["scale"])) < (
        1e-2 if dtype == torch.bfloat16 else 1e-5)
    # a row's result does not depend on how many rows the call has
    assert torch.equal(quant.int8_matmul(x[:64], q["w8"], q["scale"]), out[:64])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("w", [7, 100, 300])
def test_flash_prefill_route(dev, w, int8, d):
    """Kernel B's tensor-core route over bf16 chunks: bases 0, mid-cache and
    S - 1 (that chunk runs past the cache's end), GQA G 6, bf16 or int8 K/V,
    against the plain version (one bf16 rounding of the output)."""
    g = torch.Generator(device=dev).manual_seed(11)
    b, nh, kh, s = 3, 12, 2, 1000
    q = torch.randn(b, w, nh, d, generator=g, device=dev).to(torch.bfloat16)
    base = torch.tensor([0, 500, s - 1], dtype=torch.int32, device=dev)
    if int8:
        kc = torch.randint(-127, 128, (b, kh, s, d), generator=g, device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (b, kh, s, d), generator=g, device=dev).to(torch.int8)
        kw = dict(k_scale=torch.rand(b, kh, 1, s, generator=g, device=dev) / 127,
                  v_scale=torch.rand(b, kh, 1, s, generator=g, device=dev) / 127)
    else:
        kc, vc = (torch.randn(b, kh, s, d, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kw = {}
    before = fa.flash_cached_attention.launches_prefill
    out = fa.flash_cached_attention(q, kc, vc, base, **kw)
    assert fa.flash_cached_attention.launches_prefill == before + 1
    assert _rel(out, fa.flash_cached_attention_plain(q, kc, vc, base, **kw)) < 1e-2


def _decode_inputs(g, dev, b, w, nh, kh, s, d, q_dtype, int8):
    q = torch.randn(b, w, nh, d, generator=g, device=dev).to(q_dtype)
    if int8:
        kc = torch.randint(-127, 128, (b, kh, s, d), generator=g, device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (b, kh, s, d), generator=g, device=dev).to(torch.int8)
        kw = dict(k_scale=torch.rand(b, kh, 1, s, generator=g, device=dev) / 127,
                  v_scale=torch.rand(b, kh, 1, s, generator=g, device=dev) / 127)
    else:
        kc, vc = (torch.randn(b, kh, s, d, generator=g, device=dev).to(q_dtype) for _ in range(2))
        kw = {}
    return q, kc, vc, kw


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g_heads", [1, 6])
@pytest.mark.parametrize("q_dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                          (torch.float32, False), (torch.float32, True)])
def test_flash_decode_route(dev, q_dtype, int8, g_heads, d, b):
    """Kernel B's decode route at W = 1 for every (q, KV) dtype pair, GQA G
    1 and 6, D 64 and 128, over a 1,000-slot cache (not a multiple of its
    64-key tile) with bases 0, mid-cache, S - 1 and one more side by side:
    within 1e-2 (bf16 out) / 1e-4 (f32) of the peak of the plain version."""
    g = torch.Generator(device=dev).manual_seed(13)
    kh, s = 2, 1000
    q, kc, vc, kw = _decode_inputs(g, dev, b, 1, kh * g_heads, kh, s, d, q_dtype, int8)
    base = torch.tensor([s - 1, 0, 500, 63][:b], dtype=torch.int32, device=dev)
    before = fa.flash_cached_attention.launches
    out = fa.flash_cached_attention(q, kc, vc, base, **kw)
    assert fa.flash_cached_attention.launches == before + 1
    assert out.dtype == q_dtype and out.shape == q.shape
    assert _rel(out, fa.flash_cached_attention_plain(q, kc, vc, base, **kw)) < (
        1e-2 if q_dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_graph_replay(dev, int8):
    """One capture of the decode call in a CUDA graph, replayed with three
    other bases written in place: the split plan comes from the shapes and
    the horizon from base on the card, so every replay matches the plain
    version at its own bases (and the arrival counters reset themselves)."""
    g = torch.Generator(device=dev).manual_seed(14)
    b, nh, kh, s, d = 2, 12, 2, 4096, 128
    q, kc, vc, kw = _decode_inputs(g, dev, b, 1, nh, kh, s, d, torch.bfloat16, int8)
    base = torch.tensor([4095, 1234], dtype=torch.int32, device=dev)
    fa.flash_cached_attention(q, kc, vc, base, **kw)  # allocate outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_cached_attention(q, kc, vc, base, **kw)
    for bases in ((0, 4095), (200, 300), (3000, 17)):
        base.copy_(torch.tensor(bases, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(out, fa.flash_cached_attention_plain(q, kc, vc, base, **kw)) < 1e-2


def test_new_routes_raise_on_unsupported_input(dev):
    """Every CUDA input launches a kernel or raises: the GEMM wants OUT a
    multiple of 16 and bf16 or f32 x; the prefill route head_dim 64 or 128
    and a cache of q's dtype."""
    q = quant.quantize_weight(torch.randn(64, 40, device=dev))  # OUT 40: not a multiple of 16
    with pytest.raises(ValueError):
        quant.int8_matmul(torch.randn(100, 64, device=dev), q["w8"], q["scale"])
    q = quant.quantize_weight(torch.randn(64, 64, device=dev))
    with pytest.raises(ValueError):  # f16 x
        quant.int8_matmul(torch.randn(100, 64, device=dev).half(), q["w8"], q["scale"])
    base = torch.zeros(1, dtype=torch.int32, device=dev)
    qq = torch.randn(1, 4, 4, 96, device=dev).to(torch.bfloat16)  # head_dim 96
    cache = torch.randn(1, 2, 32, 96, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_cached_attention(qq, cache, cache, base)
    qq = torch.randn(1, 4, 4, 64, device=dev).to(torch.bfloat16)
    cache = torch.randn(1, 2, 32, 64, device=dev)  # f32 cache under bf16 q
    with pytest.raises(ValueError):
        fa.flash_cached_attention(qq, cache, cache, base)
    flat = torch.randn(2 * 32 * 64 + 1, device=dev).to(torch.bfloat16)
    cache = flat[1:].view(1, 2, 32, 64)  # contiguous, 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError):
        fa.flash_cached_attention(qq, cache, cache, base)
    # an offset q is copied, not refused
    qflat = torch.randn(4 * 4 * 64 + 1, device=dev).to(torch.bfloat16)
    qv, cache = qflat[1:].view(1, 4, 4, 64), torch.randn(1, 2, 32, 64, device=dev).to(torch.bfloat16)
    assert _rel(fa.flash_cached_attention(qv, cache, cache, base),
                fa.flash_cached_attention_plain(qv, cache, cache, base)) < 1e-2


def test_wrappers_raise_on_unsupported_input(dev):
    x = torch.randn(2, 64, device=dev)
    q = quant.quantize_weight(torch.randn(64, 30, device=dev))  # 30 columns: not a multiple of 4
    with pytest.raises(ValueError):
        quant.int8_matmul(x, q["w8"], q["scale"])
    qq = torch.randn(1, 1, 4, 64, device=dev)
    cache = torch.randn(1, 2, 32, 64, device=dev, dtype=torch.bfloat16)  # dtype differs from q
    with pytest.raises(ValueError):
        fa.flash_cached_attention(qq, cache, cache, torch.zeros(1, dtype=torch.int32, device=dev))
    qq, cache = torch.randn(1, 1, 4, 96, device=dev), torch.randn(1, 2, 32, 96, device=dev)
    with pytest.raises(ValueError):  # the decode kernel takes head_dim 16, 32, 64 or 128
        fa.flash_cached_attention(qq, cache, cache, torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("rows,k,n,dtype", [(37, 320, 208, torch.float32), (300, 1536, 256, torch.float32),
                                            (130, 96, 1008, torch.bfloat16)])
def test_int8_matmul_t(dev, rows, k, n, dtype):
    """Kernel E (ragged tiles at every edge; OUT a multiple of 16, as its TMA
    rows need): the same bf16(g*scale) x int8 products as the plain version,
    summed in another order."""
    g = torch.Generator(device=dev).manual_seed(4)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev))
    gr = torch.randn(rows, n, generator=g, device=dev).to(dtype)
    out = quant.int8_matmul_t(gr, q["w8"], q["scale"])
    assert out.dtype == dtype and out.shape == (rows, k)
    assert _rel(out, quant.int8_matmul_t_plain(gr, q["w8"], q["scale"])) < (
        1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(96, 208), (1536, 8960)])
@pytest.mark.parametrize("rows", [1, 65, 1000])
def test_int8_matmul_t_rows(dev, rows, k, n, dtype):
    """Kernel E at 1, 65 and 1,000 rows (ragged against its 192-row tile), at
    a small aligned shape and the 1.5B gate/up dx, f32 and bf16 g: within
    1e-5 (f32) / 1e-2 (bf16) of the peak, and a row's result bit-identical
    whatever the call's row count (no split-K)."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev) * 0.02)
    gr = (torch.randn(rows, n, generator=g, device=dev) * 1e-3).to(dtype)
    before = quant.int8_matmul_t.launches
    out = quant.int8_matmul_t(gr, q["w8"], q["scale"])
    assert quant.int8_matmul_t.launches == before + 1
    assert out.dtype == dtype and out.shape == (rows, k)
    assert _rel(out, quant.int8_matmul_t_plain(gr, q["w8"], q["scale"])) < (
        1e-2 if dtype == torch.bfloat16 else 1e-5)
    if rows == 1000:
        assert torch.equal(quant.int8_matmul_t(gr[:64], q["w8"], q["scale"]), out[:64])


def test_int8_matmul_t_raises_on_misaligned_shapes(dev):
    """OUT not a multiple of 16 (TMA row strides, the column permutation) or
    IN not a multiple of 4 (vector stores): the wrapper raises."""
    for k, n in ((64, 200), (30, 64)):
        q = quant.quantize_weight(torch.randn(k, n, device=dev))
        with pytest.raises(ValueError):
            quant.int8_matmul_t(torch.randn(100, n, device=dev), q["w8"], q["scale"])


def test_int8_lora_linear_gradients(dev):
    """mm over an int8 entry with a LoRA branch: kernel A forward and
    kernel E backward against the plain versions' autograd on the CPU."""
    g = torch.Generator().manual_seed(5)
    q = quant.quantize_weight(torch.randn(192, 320, generator=g))
    x, a, b = (torch.randn(*s, generator=g) for s in ((2, 33, 192), (192, 8), (8, 320)))
    res = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.to(d).requires_grad_(True) for t in (x, a, b)]
        p = {"w8": q["w8"].to(d), "scale": q["scale"].to(d), "lora": (leaves[1], leaves[2], 2.0)}
        res.append(torch.autograd.grad(torch.sin(quant.mm(leaves[0], p)).sum(), leaves))
    for got, want in zip(*res):
        assert _rel(got.cpu(), want) < 1e-4


@pytest.mark.parametrize("t,d,dtype", [(200, 64, torch.float32), (130, 128, torch.float32),
                                       (64, 128, torch.bfloat16), (77, 16, torch.float32),
                                       (96, 32, torch.bfloat16), (333, 64, torch.float32),
                                       (150, 128, torch.bfloat16), (38, 128, torch.float32),
                                       (38, 64, torch.bfloat16)])
def test_flash_train_attention(dev, t, d, dtype):
    """The training attention kernels (forward, dQ/dK/dV) against the plain
    version's autograd on a right-padded GQA batch: outputs on valid rows,
    gradients with dO zero on pad rows (what the loss gives). The second
    sample holds T - 37 valid tokens (one at T 38). D 64 and 128 take the
    tensor-core route (f32 as three bf16 terms), D 16 and 32 the CUDA cores;
    each call counts on its route only."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, nh, kh = 2, 6, 2
    q, k, v = (torch.randn(b, t, h, d, generator=g, device=dev).to(dtype) for h in (nh, kh, kh))
    valid = torch.zeros(b, t, dtype=torch.bool, device=dev)
    valid[0, :], valid[1, : t - 37] = True, True
    do = (torch.randn(b, t, nh, d, generator=g, device=dev) * valid[:, :, None, None]).to(dtype)
    route = "launches" if fa._train_plan(dtype, d) == "wgmma" else "launches_cores"
    other = "launches_cores" if route == "launches" else "launches"
    kernels = (fa.flash_train_attention_fwd, fa.flash_train_attention_bwd)
    before = [(getattr(f, route), getattr(f, other)) for f in kernels]
    res = []
    for fn in (fa.flash_train_attention, fa.train_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, valid)
        res.append((out * valid[:, :, None, None], *torch.autograd.grad(out, leaves, do)))
    assert [(getattr(f, route), getattr(f, other)) for f in kernels] == [
        (n + 1, m) for n, m in before]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(*res):
        assert got.dtype == dtype and _rel(got, want) < tol


@pytest.mark.parametrize("t", [1, 63, 64, 65, 130, 1500, 8192])
def test_train_walk_kernel_matches_plain(dev, t):
    """The tile walks as the card computes them (flash_train_walk) against
    the plain version: a right-padded batch (full, ragged, one valid token),
    packed runs of distinct ids, and ids in no order."""
    rng = np.random.RandomState(t)
    padded = np.zeros((3, t), np.int32)
    for i, n in enumerate((t, max(1, t - 37), 1)):
        padded[i, :n] = 1
    packed = np.cumsum(rng.rand(2, t) < 0.01, axis=1).astype(np.int32)
    scattered = rng.randint(-3, 3, (2, t)).astype(np.int32)
    for seg in (padded, packed, scattered):
        seg = torch.from_numpy(seg)
        got = fa._train_walk(seg.to(dev))
        want = fa._train_walk(seg)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu(), w_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_attention_repeats_bit_identical(dev, dtype):
    """The tensor-core route has no atomics: two calls on the same inputs
    give the same bits (O, LSE, dQ, dK, dV)."""
    g = torch.Generator(device=dev).manual_seed(9)
    b, t, h, d = 2, 300, 4, 128
    q, k, v, do = (torch.randn(b, t, h, d, generator=g, device=dev).to(dtype) for _ in range(4))
    seg = torch.ones(b, t, dtype=torch.int32, device=dev)
    seg[1, 200:] = 0
    runs = []
    for _ in range(2):
        o, lse = fa.flash_train_attention_fwd(q, k, v, seg, d ** -0.5)
        runs.append((o, lse, *fa.flash_train_attention_bwd(q, k, v, seg, o, lse, do, d ** -0.5)))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float32, 16)])
def test_flash_ring_block(dev, dtype, d):
    """Kernel F over the three hops of rank 1 of a 3-ring (its own block,
    rank 0's, then rank 2's, wholly in the future) against the plain fold,
    state after every hop: GQA G 3, ragged query and key tiles, one sample
    ending inside rank 1's block and one inside rank 0's (no live key on the
    first hop). The future hop leaves the kernel's state bit-identical."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, tl, nh, kh, n, rank = 3, 100, 6, 2, 3, 1
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q = rn(b, tl, nh, d)
    blocks = [(rn(b, kh, tl, d), rn(b, kh, tl, d)) for _ in range(n)]
    k_len = torch.tensor([n * tl, 150, 60], dtype=torch.int32, device=dev)
    kern = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
    plain = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
    for hop in range(n):
        src = (rank - hop) % n
        kw = dict(q_start=rank * tl, k_start=src * tl, k_len=k_len)
        before = [x.clone() for x in kern]
        fa.flash_ring_block(kern, q, *blocks[src], **kw)
        fa.flash_ring_block_plain(plain, q, *blocks[src], q_chunk=7, **kw)
        for got, want in zip(kern, plain):
            assert _rel(got, want) < 1e-5
        if src == 2:
            assert all(torch.equal(x, y) for x, y in zip(kern, before))
    assert _rel(fa.ring_state_out(kern, tl, torch.float32),
                fa.ring_state_out(plain, tl, torch.float32)) < 1e-5


def test_flash_ring_block_raises_on_unsupported_input(dev):
    k_len = torch.full((1,), 8, dtype=torch.int32, device=dev)
    q, kv = torch.randn(1, 8, 2, 64, device=dev), torch.randn(1, 1, 8, 64, device=dev)
    with pytest.raises(ValueError):  # f32 at D 64: the kernel is built for f32 at D 16 only
        fa.flash_ring_block(fa.ring_state_init(1, 1, 16, 64, device=dev), q, kv, kv, q_start=0,
                            k_start=0, k_len=k_len)
    q, kv = torch.randn(1, 8, 2, 16, device=dev), torch.randn(1, 1, 8, 16, device=dev)
    m, l, acc = fa.ring_state_init(1, 1, 16, 16, device=dev)
    with pytest.raises(ValueError):  # the state must be f32
        fa.flash_ring_block((m, l, acc.double()), q, kv, kv, q_start=0, k_start=0, k_len=k_len)


def test_training_wrappers_raise_on_unsupported_input(dev):
    q = torch.randn(1, 8, 2, 96, device=dev)  # D 96: no route (16, 32, 64, 128)
    seg = torch.ones(1, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fa.flash_train_attention_fwd(q, q, q, seg, 0.1)
    q = torch.randn(1, 8, 2, 128, device=dev)
    with pytest.raises(ValueError):  # f16: the tensor-core route takes f32 or bf16
        fa.flash_train_attention_fwd(q.half(), q.half(), q.half(), seg, 0.1)
    with pytest.raises(ValueError):  # q, k, v of two dtypes
        fa.flash_train_attention_fwd(q, q.bfloat16(), q, seg, 0.1)
    with pytest.raises(ValueError):  # segment ids must be int32
        fa.flash_train_attention_fwd(q, q, q, seg.long(), 0.1)
    with pytest.raises(ValueError):  # K with other heads than q: the wrapper repeats GQA
        fa.flash_train_attention_bwd(q, q[:, :, :1].contiguous(), q, seg, q, seg.float(), q, 0.1)
    with pytest.raises(ValueError):
        quant.int8_matmul_t(torch.randn(2, 8, device=dev), torch.zeros(4, 8, dtype=torch.int8,
                                                                      device=dev),
                            torch.ones(8, dtype=torch.float64, device=dev))


# ---------------------------------------------------------------------------
# The ring over NCCL, one rank per card (two cards or more)
# ---------------------------------------------------------------------------

TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)


def _ring_attention_inputs():
    """1.5B attention widths (12 query heads over 2 KV heads, D 128), bf16,
    T 2048 right-padded: sample 1 holds 1500 tokens."""
    rng = np.random.RandomState(8)
    b, t, nh, kh, d = 2, 2048, 12, 2, 128
    q, k, v = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(torch.bfloat16)
               for h in (nh, kh, kh))
    valid = torch.ones(b, t, dtype=torch.bool)
    valid[1, 1500:] = False
    return q, k, v, valid


def _tiny_prefill_inputs():
    """Tiny config, f32 weights with the int8 LM (kernel A), and two
    right-padded prompts of 50 and 37 tokens (50 is not a multiple of 4)."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    params = vv.quantize_for_inference(init(cfg, seed=0, device="cpu"), ("lm", "lm_head"))
    rng = np.random.RandomState(9)
    ids = torch.from_numpy(rng.randint(10, 100, (2, 50)).astype(np.int64))
    valid = torch.ones(2, 50, dtype=torch.bool)
    valid[1, 37:] = False
    ids[0, -1] = ids[1, 36] = TOK["speech_start"]
    return cfg, params, ids, valid, 64


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _nccl_rank(rank, world, store, out):
    import torch.distributed as dist

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.parallel import make_mesh, ring_attention, ring_prefill_carry

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_mesh(dp=1, tp=world)
        attn = ring_attention(*(x.to(dev) for x in _ring_attention_inputs()), mesh)
        cfg, params, ids, valid, max_len = _tiny_prefill_inputs()
        carry = ring_prefill_carry(cfg, _to(params, dev), ids.to(dev), valid.to(dev), max_len,
                                   inf.SpecialTokens(**TOK), mesh)
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"attn": attn.cpu(), "carry": _to(carry, "cpu")}, out)
    finally:
        dist.destroy_process_group()


def test_ring_over_nccl(dev, tmp_path):
    """Ring attention (kernel F on every hop, K/V passed between cards) and
    the sequence-parallel prefill in an NCCL world of one rank per card (up
    to 4): the gathered attention against dense attention of the same bf16
    inputs in f32 (one bf16 rounding of the output, 1e-2 of the peak); the
    tiny-config ring carry against inference.prefill_fn on one card through
    kernel B (f32, summation order only: 1e-4 of the peak)."""
    import torch.multiprocessing as mp

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.ops import _cuda

    world = min(4, torch.cuda.device_count())
    if world < 2:
        pytest.skip("needs two or more CUDA devices")
    _cuda.library()  # built once here, not by every rank
    out = tmp_path / "rank0.pt"
    mp.spawn(_nccl_rank, args=(world, str(tmp_path / "pg"), str(out)), nprocs=world)
    got = torch.load(out, weights_only=False)

    q, k, v, valid = (x.to(dev) for x in _ring_attention_inputs())
    g = q.shape[2] // k.shape[2]
    kr, vr = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * q.shape[-1] ** -0.5
    t = q.shape[1]
    ok = torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None] & valid[:, None, :]
    want = torch.einsum("bhqk,bkhd->bqhd", s.masked_fill(~ok[:, None], float("-inf")).softmax(-1), vr)
    assert _rel(got["attn"].to(dev)[valid], want[valid]) < 1e-2

    cfg, params, ids, valid, max_len = _tiny_prefill_inputs()
    ref = inf.prefill_fn(cfg, _to(params, dev), ids.to(dev), max_len, valid.to(dev), None,
                         inf.SpecialTokens(**TOK))
    ring = _to(got["carry"], dev)
    assert torch.equal(ring.cache.length, ref.cache.length)
    assert _rel(ring.h_pos, ref.h_pos) < 1e-4 and _rel(ring.h_neg, ref.h_neg) < 1e-4
    for li in range(cfg.decoder_config.num_hidden_layers):
        for bi, n in enumerate(valid.sum(1).tolist()):
            for gc, wc in ((ring.cache.k[li], ref.cache.k[li]), (ring.cache.v[li], ref.cache.v[li])):
                assert _rel(gc[bi, :, :n], wc[bi, :, :n]) < 1e-4


# ---------------------------------------------------------------------------
# The compiled frame step: generate() replaying a CUDA graph
# ---------------------------------------------------------------------------


def _tiny_serving(dev, seed=0):
    """Tiny config with the serving packs (int8 LM and lm_head, kernels C
    and D), f32 activations, on the card; the tokenizer blocks' layer scales
    at 0.3 so that every block does work."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    p = init(cfg, seed=seed, device="cpu")
    for part in (p["acoustic_tokenizer"]["decoder"], p["semantic_tokenizer"]["encoder"]):
        for blk in (b for stage in part["stages"] for b in stage):
            blk["gamma"].fill_(0.3)
            blk["ffn_gamma"].fill_(0.3)
    return cfg, vv.fuse_for_serving(vv.quantize_for_inference(_to(p, dev)), cfg, quantize=True)


def _step_case(cfg, mode, k, prompt_seed=0):
    """generate() keywords for one case: "plain" (argmax, latents from the
    seeded generator), "inject" (noise_bank and forced_tokens), "sde" (the
    SDE solver and do_sample, all draws from the generator) or "sample"
    (do_sample with top_p 0.8). Two right-padded prompts, max_length 48,
    2 solver steps. In "plain", speech_diffusion is id 5, the candidate
    this random model's argmax chooses first, so that a frame diffuses."""
    from vibevoice_tpu_torch.models import inference as inf

    rng = np.random.RandomState(prompt_seed)
    ids = rng.randint(10, 100, (2, 10)).astype(np.int64)
    valid = np.ones((2, 10), bool)
    valid[1, 8:] = False
    ids[0, 9] = ids[1, 7] = TOK["speech_start"]
    opts = dict(ddpm_steps=2, max_length=48, frames_per_dispatch=k)
    tok = {**TOK, "speech_start": 7, "speech_diffusion": 5} if mode == "plain" else TOK
    kw = dict(input_ids=ids, valid_mask=valid, tokens=inf.SpecialTokens(**tok), seed=0)
    if mode == "inject":
        kw["noise_bank"] = {"init": rng.randn(8, 2, cfg.acoustic_vae_dim).astype(np.float32)}
        forced = np.full((12, 2), TOK["speech_diffusion"], np.int64)
        forced[3] = [TOK["speech_end"], -1]
        forced[4, 0] = TOK["speech_start"]
        forced[11, 1] = TOK["eos"]
        kw["forced_tokens"] = forced
    elif mode == "sde":
        opts.update(sde=True, do_sample=True)
    elif mode == "sample":
        opts.update(do_sample=True, top_p=0.8)
    return {**kw, "opts": inf.GenerateOptions(**opts)}


def _default_step_fn(cfg, kw):
    from vibevoice_tpu_torch.models import inference as inf

    o, inject = kw["opts"], "noise_bank" in kw or "forced_tokens" in kw
    if o.frames_per_dispatch > 1:
        return inf.make_multi_step_fn(cfg, kw["tokens"], o, o.frames_per_dispatch, inject)
    return inf.make_step_fn(cfg, kw["tokens"], o, inject)


def _captures_of(fn):
    from vibevoice_tpu_torch.models import inference as inf

    return [c for key, c in inf._captures.items() if key[0] is fn]


def _assert_same_run(got, want, tol=1e-5):
    """Identical tokens and reach_max flags; audio within `tol` of the peak
    (a replay runs the eager frame's kernels on the same inputs, so the
    bits are expected to agree; the limit leaves room for a library
    routine that picks another algorithm under capture)."""
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.reach_max_step_sample, want.reach_max_step_sample)
    for a, b in zip(got.speech_outputs, want.speech_outputs):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and np.isfinite(a).all()
            assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-6)


@pytest.mark.parametrize("mode", ["plain", "inject", "sde", "sample"])
@pytest.mark.parametrize("k", [1, 4])
def test_graphed_generate_matches_eager(dev, k, mode):
    """The default generate() on the card replays a captured graph of K
    frames; the same run through the step function's eager call gives the
    same tokens and audio within 1e-5 of the peak."""
    from vibevoice_tpu_torch.models import inference as inf

    cfg, params = _tiny_serving(dev)
    kw = _step_case(cfg, mode, k)
    fn = _default_step_fn(cfg, kw)
    replays = fn.replays
    graphed = inf.generate(cfg, params, **kw)
    assert fn.replays > replays
    replays = fn.replays
    eager = inf.generate(cfg, params, step_fn=fn.eager, **kw)
    assert fn.replays == replays
    assert graphed.sequences.shape[1] > (10 + k if mode == "inject" else 10)
    _assert_same_run(graphed, eager)


def test_graphed_generate_reuses_its_capture(dev):
    """A second generate() with another prompt of the same shapes replays
    the first call's capture (no new one) and equals its eager run."""
    from vibevoice_tpu_torch.models import inference as inf

    cfg, params = _tiny_serving(dev)
    first = _step_case(cfg, "sample", 4, prompt_seed=0)
    fn = _default_step_fn(cfg, first)
    inf.generate(cfg, params, **first)
    captures, replays = _captures_of(fn), fn.replays
    second = _step_case(cfg, "sample", 4, prompt_seed=1)
    graphed = inf.generate(cfg, params, **second)
    assert _captures_of(fn) == captures and fn.replays > replays
    _assert_same_run(graphed, inf.generate(cfg, params, step_fn=fn.eager, **second))


def test_graph_survives_grown_decode_counters(dev):
    """A graph captured before kernel B's decode counters grow still
    replays right: the counters are one per (sample, KV head, row tile),
    so a decode call with more of those than the buffer holds (here 8 KV
    heads and enough samples, over a 64-slot cache; the cache's length
    does not size them) replaces the buffer, and the old one, which the
    graph launches read, stays allocated."""
    from vibevoice_tpu_torch.models import inference as inf

    cfg, params = _tiny_serving(dev)
    kw = _step_case(cfg, "plain", 1)
    first = inf.generate(cfg, params, **kw)  # captures
    dev = torch.device("cuda", torch.cuda.current_device())  # the counters' key
    old = fa._decode_counters[dev]
    b = old.numel() // 8 + 1
    q = torch.randn(b, 1, 8, 64, device=dev).to(torch.bfloat16)
    kc = torch.randn(b, 8, 64, 64, device=dev).to(torch.bfloat16)
    out = fa.flash_cached_attention(q, kc, kc, torch.full((b,), 40, dtype=torch.int32, device=dev))
    assert fa._decode_counters[dev] is not old and any(t is old for t in fa._decode_retired)
    torch.testing.assert_close(out.float(), fa.flash_cached_attention_plain(
        q, kc, kc, torch.full((b,), 40, dtype=torch.int32, device=dev)).float(),
        rtol=1e-2, atol=1e-2)
    del out, q, kc
    torch.cuda.empty_cache()
    torch.empty(64 << 20, dtype=torch.uint8, device=dev).fill_(0xFF)  # dirty freed memory
    again = inf.generate(cfg, params, **kw)  # replays the first capture
    torch.cuda.synchronize()
    _assert_same_run(again, first, tol=0.0)


def test_replays_count_the_captured_launches(dev):
    """After N replays each kernel counter has grown by N times its count
    in the capture (beside the eager prefill's launches), which equals what
    the eager run launches."""
    from vibevoice_tpu_torch.models import inference as inf

    cfg, params = _tiny_serving(dev)
    kw = _step_case(cfg, "inject", 4)
    fn = _default_step_fn(cfg, kw)
    inf.generate(cfg, params, **kw)  # captures (the memo may hold other tests' captures)
    cap = next(c for c in _captures_of(fn) if c.params is params)
    assert sum(cap.launches.values()) > 0
    counters = _cuda.LAUNCH_COUNTERS

    def counts(run):
        for f, a in counters.values():
            setattr(f, a, 0)
        run()
        return {name: getattr(f, a) for name, (f, a) in counters.items()}

    prefill = counts(lambda: inf.prefill_fn(
        cfg, params, torch.as_tensor(kw["input_ids"], device=dev), 48,
        torch.as_tensor(kw["valid_mask"], device=dev), None, kw["tokens"]))
    replays = fn.replays
    graphed = counts(lambda: inf.generate(cfg, params, **kw))
    n = fn.replays - replays
    eager = counts(lambda: inf.generate(cfg, params, step_fn=fn.eager, **kw))
    assert n > 1
    assert graphed == {k: p + n * cap.launches.get(k, 0) for k, p in prefill.items()}
    assert graphed == eager


def test_concurrent_requests_share_a_capture_one_at_a_time(dev):
    """Two generate() calls on two threads with one step function (the
    same options and shapes, so one capture and one static carry) each
    give what the call gives alone: a request owns the step function from
    its first window to its last, so neither continues from the other's KV
    cache and states. The first pair's capture runs while the other
    thread enqueues its prefill."""
    import threading

    from vibevoice_tpu_torch.models import inference as inf

    cfg, params = _tiny_serving(dev)
    cases = [_step_case(cfg, "inject", 4, prompt_seed=s) for s in (0, 1)]
    fn = _default_step_fn(cfg, cases[0])
    alone = [inf.generate(cfg, params, **kw) for kw in cases]
    for key in [k for k in inf._captures if k[0] is fn]:
        del inf._captures[key]
    for _ in range(2):  # one thread captures while the other prefills, then both replay
        got, start = [None, None], threading.Barrier(2)

        def run(i):
            start.wait()
            got[i] = inf.generate(cfg, params, **cases[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        replays = fn.replays
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fn.replays > replays
        for g, a, kw in zip(got, alone, cases):
            _assert_same_run(g, a, tol=0.0)
            _assert_same_run(g, inf.generate(cfg, params, step_fn=fn.eager, **kw))


def test_streams_read_in_turn_match_their_runs_alone(dev):
    """Two VibeVoiceTTS.stream() iterators read in turn (each generates on
    a thread of its own, both through one step function) give the frames
    that each stream gives when read alone."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor
    from vibevoice_tpu_torch.processor.text_tokenizer import FallbackTextTokenizer
    from vibevoice_tpu_torch.tts import VibeVoiceTTS

    cfg, params = _tiny_serving(dev)
    hop = cfg.acoustic_tokenizer_config.hop_length
    proc = VibeVoiceProcessor(tokenizer=FallbackTextTokenizer(), speech_tok_compress_ratio=hop)
    # speech_diffusion at id 5, which this random model samples often
    tts = VibeVoiceTTS(cfg, params, proc, inf.SpecialTokens(**{**TOK, "speech_start": 7,
                                                                "speech_diffusion": 5}))
    voice = np.random.RandomState(1).randn(3 * hop).astype(np.float32)
    scripts = ("Speaker 1: hello there", "Speaker 1: good morning to you all")
    # the random model may sample eos before any speech frame: the first
    # seed under which both streams speak alone is the one read in turn
    for seed in range(16):
        kw = dict(voices=[voice], seed=seed, ddpm_steps=2, max_length=96, frames_per_dispatch=4,
                  do_sample=True, top_p=0.9)
        alone = [[np.array(c) for c in tts.stream(s, **kw)] for s in scripts]
        if all(len(frames) > 0 for frames in alone):
            break
    else:
        pytest.fail("no seed under 16 gives both streams a speech frame")
    turns: list = [[], []]
    streams = [iter(tts.stream(s, **kw)) for s in scripts]
    live = [True, True]
    while any(live):
        for i, it in enumerate(streams):
            if live[i]:
                try:
                    turns[i].append(np.array(next(it)))
                except StopIteration:
                    live[i] = False
    for got, want in zip(turns, alone):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the streaming 0.5B model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,s,int8,base", [
    (1, 8192, False, 286), (1, 8192, False, 8191), (1, 16384, True, 286), (1, 16384, True, 16383),
    (5, 8192, False, 290), (256, 8192, False, 0)])
def test_flash_cached_attention_streaming_shapes(dev, w, s, int8, base):
    """Kernel B at the 0.5B's shapes: 14 query heads over 2 KV heads (G 7:
    7 folded rows in the decode tile, 35 in a W = 5 prefill tile), head_dim
    64, one sample; decode over bf16 and int8 caches at a stream's fill and
    full, the prefill route at a text window and at the voice preset's
    256-token prompt: within 1e-2 of the plain version's peak, one launch
    of the expected route."""
    g = torch.Generator(device=dev).manual_seed(15)
    q, kc, vc, kw = _decode_inputs(g, dev, 1, w, 14, 2, s, 64, torch.bfloat16, int8)
    base_t = torch.tensor([base], dtype=torch.int32, device=dev)
    attr = "launches" if w == 1 else "launches_prefill"
    before = getattr(fa.flash_cached_attention, attr)
    out = fa.flash_cached_attention(q, kc, vc, base_t, **kw)
    assert getattr(fa.flash_cached_attention, attr) == before + 1
    assert _rel(out, fa.flash_cached_attention_plain(q, kc, vc, base_t, **kw)) < 1e-2


def _tiny_streaming(dev, fused: bool):
    """The tiny streaming model of StreamingTTS.smoke (f32), its vocoder
    stage packed int8 for kernel D when `fused`, the layer scales at 0.3 and
    the EOS bias at -30 (the stream runs to its stop), with its preset and
    a noise bank; the weights are drawn on the CPU and moved."""
    from vibevoice_tpu_torch.models import streaming as st
    from vibevoice_tpu_torch.tts import StreamingTTS

    tts = StreamingTTS.smoke(device="cpu")
    cfg, p = tts.cfg, tts.params
    for blk in (b for stage in p["acoustic_tokenizer"]["decoder"]["stages"] for b in stage):
        blk["gamma"].fill_(0.3)
        blk["ffn_gamma"].fill_(0.3)
    p["tts_eos_classifier"]["fc2"]["b"].fill_(-30.0)
    preset = st.build_voice_preset(cfg, p, np.random.RandomState(0).randint(10, 200, (1, 16)),
                                   neg_prompt_id=3, max_len=512)
    bank = {"init": np.random.RandomState(1).randn(30, 1, cfg.acoustic_vae_dim).astype(np.float32)}
    p_dev = _to(p, dev)
    if fused:  # packed on each device (the pack is no dict of tensors)
        p, p_dev = (st.fuse_vocoder(x, cfg, quantize=True) for x in (p, p_dev))
    return cfg, p_dev, p, preset, bank


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_streaming_card_matches_cpu(dev, fused, kv_int8):
    """The tiny streaming model's generate() on the card (kernels, graphed
    windows) against the CPU (plain versions), same weights and noise bank:
    audio within 1e-3 of the peak (f32, summation order), the same stop
    (the capacity of 64 slots after five windows of a 16-row preset)."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import streaming as st

    cfg, p_dev, p_cpu, preset, bank = _tiny_streaming(dev, fused)
    kw = dict(tts_text_ids=np.arange(10, 22)[None], preset=preset, max_len=64, noise_bank=bank,
              opts=inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=3, kv_int8=kv_int8))
    got, want = st.generate(cfg, p_dev, **kw), st.generate(cfg, p_cpu, **kw)
    a, b = got.speech_outputs[0], want.speech_outputs[0]
    assert a.shape == b.shape and len(a) == 30 * cfg.acoustic_tokenizer_config.hop_length
    assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    np.testing.assert_array_equal(got.reach_max_step_sample, want.reach_max_step_sample)


@pytest.mark.parametrize("sde", [False, True])
def test_streaming_graphed_matches_eager(dev, sde):
    """The default (graphed) windows against their eager calls: the same
    audio bits and the same launch counts of kernels B and D, with graph
    replays; drawn noise (sde draws the SDE noise too) from the seed. The
    first run, which captures (and runs one eager window of each kind
    before each capture), gives the same audio too."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import streaming as st

    cfg, p_dev, _, preset, _ = _tiny_streaming(dev, True)
    opts = inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=3, sde=sde)
    fns = st.make_window_fns(cfg, opts)[0].fns
    kw = dict(tts_text_ids=np.arange(10, 22)[None], preset=preset, max_len=64, opts=opts, seed=4)
    names = ("flash_cached_attention", "fused_stage_step")
    runs = []
    for window_fns in (None, None, (fns.text.eager, fns.speech.eager, fns.single.eager)):
        for n in names:
            setattr(*_cuda.LAUNCH_COUNTERS[n], 0)
        replays = fns.replays
        out = st.generate(cfg, p_dev, window_fns=window_fns, **kw)
        runs.append((out.speech_outputs[0], {n: getattr(*_cuda.LAUNCH_COUNTERS[n]) for n in names},
                     fns.replays - replays))
    (first, _, _), (graphed, g_counts, g_replays), (eager, e_counts, e_replays) = runs
    assert g_replays == 8 and e_replays == 0  # three text and five speech windows
    np.testing.assert_array_equal(graphed, eager)
    np.testing.assert_array_equal(first, graphed)
    assert g_counts == e_counts and all(g_counts.values())


def test_streaming_tts_smoke_on_the_card(dev):
    """StreamingTTS.smoke() builds on the card by default and streams."""
    from vibevoice_tpu_torch.tts import StreamingTTS

    tts = StreamingTTS.smoke()
    assert tts.params["language_model"]["embed"].device.type == "cuda"
    chunks = list(tts.stream("hello streaming world", seed=0, stop_check_fn=lambda: False))
    assert chunks and all(np.isfinite(c).all() for c in chunks)


# ---------------------------------------------------------------------------
# The serving engines: kernels A-D at batched rows, the engines on the card
# ---------------------------------------------------------------------------


def _graph_equals_eager(call, inputs):
    """One capture of call() in a CUDA graph, replayed twice with new
    inputs written in place: each replay gives the bits of an eager call
    on the same inputs."""
    tup = lambda o: o if isinstance(o, tuple) else (o,)
    call()  # workspaces and counters outside the capture
    torch.cuda.synchronize()
    before = [t.clone() for t in inputs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = tup(call())
    for i in range(2):
        for t, b in zip(inputs, before):
            t.copy_(torch.roll(b, i + 1, dims=-1) * (1 + 0.5 * i))
        graph.replay()
        eager = tup(call())
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


@pytest.mark.parametrize("k,n", [(1536, 1536), (1536, 8960), (8960, 1536)])
def test_int8_matmul_eight_rows_graph_equals_eager(dev, k, n):
    """Kernel A's GEMV at 8 rows (a bs4 batch's two CFG streams) replayed
    from a CUDA graph gives the eager call's bits, within 1e-2 of plain."""
    g = torch.Generator(device=dev).manual_seed(41)
    w = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(8, k, generator=g, device=dev).to(torch.bfloat16)
    assert _rel(quant.int8_matmul(x, w["w8"], w["scale"]),
                quant.int8_matmul_plain(x, w["w8"], w["scale"])) < 1e-2
    _graph_equals_eager(lambda: quant.int8_matmul(x, w["w8"], w["scale"]), (x,))


@pytest.mark.parametrize("quantize", [True, False])
def test_fused_head_ffn_stack_eight_rows(dev, quantize):
    """Kernel C at the 1.5B head's widths with 8 rows (bs4 with CFG): within
    1e-4 of the plain version's peak (f32), and a graph replay gives the
    eager call's bits."""
    packed, x, mods = _head_inputs(dev, 42, 4, 1536, 4608, 8, quantize)
    assert _rel(hf.fused_head_ffn_stack(packed, x, mods),
                hf.fused_head_ffn_stack_plain(packed, x, mods)) < 1e-4
    _graph_equals_eager(lambda: hf.fused_head_ffn_stack(packed, x, mods), (x, mods))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("rows", [4, 8])
def test_fused_stage_step_batched_rows(dev, rows, quantize):
    """Kernel D at the vocoder stage's widths with 4 rows (the 1.5B at bs4)
    and 8 (eight 0.5B sessions), bf16: y and the new state within 2e-2 of
    the plain version's peak; a graph replay gives the eager call's bits."""
    packed, x, st = _stage_inputs(dev, 43, 8, 2048, rows, quantize, torch.bfloat16)
    (y, ns), (yr, nsr) = (vf.fused_stage_step(packed, x, st),
                          vf.fused_stage_step_plain(packed, x, st))
    assert _rel(y, yr) < 2e-2 and _rel(ns, nsr) < 2e-2
    _graph_equals_eager(lambda: vf.fused_stage_step(packed, x, st), (x, st))


@pytest.mark.parametrize("heads,s,int8,bases", [
    ((12, 2, 128), 4096, False, (0, 17, 2048, 4095, 5096, 1, 9, 33)),
    ((12, 2, 128), 65536, True, (0, 17, 32768, 65535, 66536, 1, 9, 33)),
    ((14, 2, 64), 8192, False, (286, 300, 0, 8191, 4000, 17, 290, 9191)),
    ((14, 2, 64), 8192, False, (31, 7, 1, 40, 8191, 17, 0, 12))])
def test_flash_decode_eight_mixed_rows(dev, heads, s, int8, bases):
    """Kernel B's decode route over 8 rows of one batch whose bases differ
    by thousands, an idle row's base past the cache among them (a free
    slot's length keeps moving): the 1.5B's layout at 4,096 bf16 and 65,536
    int8 slots, the 0.5B's at 8,192 (the positive and the negative cache of
    eight sessions). Within 1e-2 of the plain version's peak; a graph
    replay with new q and the bases moved between rows (and past the
    cache) gives the eager call's bits."""
    g = torch.Generator(device=dev).manual_seed(44)
    nh, kh, d = heads
    q, kc, vc, kw = _decode_inputs(g, dev, 8, 1, nh, kh, s, d, torch.bfloat16, int8)
    base = torch.tensor(bases, dtype=torch.int32, device=dev)
    assert _rel(fa.flash_cached_attention(q, kc, vc, base, **kw),
                fa.flash_cached_attention_plain(q, kc, vc, base, **kw)) < 1e-2
    _graph_equals_eager(lambda: fa.flash_cached_attention(q, kc, vc, base, **kw), (q, base))


def _tiny_speaking(device, pack=False):
    """_tiny_serving's model made to speak (utils.params.speaking: greedy
    decoding diffuses at every frame), and its special tokens; with
    ``pack`` its int8 q|k|v and gate|up packed (LM_PACK=1's layout)."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.utils.params import speaking

    tokens = inf.SpecialTokens(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
    cfg, params = _tiny_serving(device)
    params = speaking(params, tokens)
    if pack:
        params = {**params, "lm": quant.pack_lm_projections(params["lm"])}
    return cfg, params, tokens


def _tiny_engine(device, frames=2, pack=False):
    """A 2-slot engine over _tiny_speaking whose frame noise is each
    request's own draws (a CPU generator seeded with the request's seed),
    so the card and the CPU decode the same numbers."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving import ServingEngine

    cfg, params, tokens = _tiny_speaking(device, pack)
    eng = ServingEngine(cfg, params, tokens=tokens, max_batch=2, max_len=96,
                        opts=inf.GenerateOptions(ddpm_steps=2, max_length=96),
                        frames_per_dispatch=frames)
    draws = {}

    def draw():
        init = torch.zeros(frames, 2, cfg.acoustic_vae_dim)
        for i, h in enumerate(eng.slots):
            if h is not None:
                if h not in draws:
                    g = torch.Generator().manual_seed(h.request.seed)
                    draws[h] = torch.randn(96, cfg.acoustic_vae_dim, generator=g)
                s = int(eng.slot_steps[i])
                init[:, i] = draws[h][s: s + frames]
        return inf.FrameNoise(init.to(device), None, None)

    eng._draw_noise = draw
    return eng


def _tiny_request(seed, n):
    from vibevoice_tpu_torch.serving import Request

    ids = np.random.RandomState(seed).randint(10, 100, (1, n)).astype(np.int64)
    ids[0, -1] = 5
    return Request(input_ids=ids, valid_mask=np.ones((1, n), bool), seed=seed)


def test_serving_engine_card_matches_cpu(dev):
    """Three requests through a 2-slot engine on the card (kernels A-D,
    the graphed step) and on the CPU (plain versions), each slot given its
    request's draws: the same tokens, every waveform its frame cap, within
    1e-3 of the CPU's peak."""
    runs = []
    for device in (dev, torch.device("cpu")):
        eng = _tiny_engine(device)
        try:
            handles = [eng.submit(_tiny_request(50 + i, 6 + 3 * i)) for i in range(3)]
            runs.append([(h.result(timeout=300), list(h.tokens)) for h in handles])
        finally:
            eng.shutdown()
    hop = 8
    for i, ((a, ta), (b, tb)) in enumerate(zip(*runs)):
        assert ta == tb and len(a) == len(b) == min(96 - (6 + 3 * i), 2 * (6 + 3 * i)) * hop
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def test_serving_engine_packed_card_matches_cpu(dev):
    """The engine over a packed int8 LM (LM_PACK=1's qkv / gateup): its
    capture takes the packed tree, and two requests on the card give the
    CPU's tokens and audio within 1e-3 of its peak."""
    runs = []
    for device in (dev, torch.device("cpu")):
        eng = _tiny_engine(device, pack=True)
        try:
            handles = [eng.submit(_tiny_request(70 + i, 6 + 3 * i)) for i in range(2)]
            runs.append([(h.result(timeout=300), list(h.tokens)) for h in handles])
        finally:
            eng.shutdown()
    for (a, ta), (b, tb) in zip(*runs):
        assert ta == tb and len(a) == len(b) > 0
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def test_serving_engine_replays_on_its_carry_and_recaptures(dev, monkeypatch):
    """After warmup() the engine's carry is its capture's static carry:
    requests join into it and windows replay with no whole-carry copy and
    no change of its tensors. Evicting the capture makes the next window
    capture again from the engine's carry, which it then keeps; a request
    decoded after that gives the audio it gave before."""
    from vibevoice_tpu_torch.models import inference as inf

    copies = []
    real_copy = inf._copy_into
    monkeypatch.setattr(inf, "_copy_into", lambda dst, src: (
        copies.append(dst) if isinstance(dst, inf.DecodeCarry) else None, real_copy(dst, src)))
    eng = _tiny_engine(dev)
    try:
        eng.warmup(prompt_tokens=8, timeout=300)
        caps = [c for c in inf._captures.values() if getattr(c, "carry", None) is eng.carry]
        assert len(caps) == 1 and eng.step_fn.replays > 0
        leaves = lambda c: [t.data_ptr() for t in (*c.cache.k, c.cache.length, c.h_pos, c.finished)]
        ptrs, replays, n_copies = leaves(eng.carry), eng.step_fn.replays, len(copies)
        first = eng.submit(_tiny_request(60, 10)).result(timeout=300)
        others = [eng.submit(_tiny_request(61 + i, 8)) for i in range(2)]
        [h.result(timeout=300) for h in others]
        assert len(copies) == n_copies and leaves(eng.carry) == ptrs
        assert eng.carry is caps[0].carry and eng.step_fn.replays > replays
        inf._captures.clear()
        again = eng.submit(_tiny_request(60, 10)).result(timeout=300)
        assert len(copies) > n_copies  # the new capture took the engine's carry once
        new = [c for c in inf._captures.values() if getattr(c, "carry", None) is eng.carry]
        assert len(new) == 1 and new[0] is not caps[0]
        assert len(again) == len(first)
        assert np.abs(again - first).max() <= 1e-3 * np.abs(first).max()
    finally:
        eng.shutdown()


def test_session_engine_card_matches_cpu(dev):
    """Three sessions over two slots of StreamingSessionEngine in inject
    mode on the card (kernels B and D, the graphed windows) and on the CPU,
    with the same banks: audio within 1e-3 of the CPU's peak, 12 frames
    each."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.streaming_sessions import StreamingSessionEngine

    cfg, p_dev, p_cpu, preset, _ = _tiny_streaming(dev, True)
    banks = [{"init": np.random.RandomState(70 + i).randn(30, 1, cfg.acoustic_vae_dim)
              .astype(np.float32)} for i in range(3)]
    runs = []
    for params in (p_dev, p_cpu):
        eng = StreamingSessionEngine(cfg, params, n_slots=2, max_len=96, inject=True,
                                     opts=inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=3))
        try:
            hs = [eng.submit(np.arange(10 + i, 19 + i), preset, noise_bank=banks[i],
                             max_new_frames=12) for i in range(3)]
            runs.append([h.result(timeout=300) for h in hs])
        finally:
            eng.shutdown(drain=False)
    for a, b in zip(*runs):
        assert len(a) == len(b) == 12 * cfg.acoustic_tokenizer_config.hop_length
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


# ---------------------------------------------------------------------------
# checkpoint loading on the card
# ---------------------------------------------------------------------------


def _tiny_checkpoint(path, monkeypatch):
    """A tiny untied multi-speaker checkpoint (three bf16 shards), written
    by chip_smoke's reference-layout writer from the port's init."""
    import dataclasses
    import json

    import chip_smoke
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, decoder_config=dataclasses.replace(
        cfg.decoder_config, tie_word_embeddings=False))
    params = init(cfg, seed=4, dtype=torch.bfloat16, device="cpu")
    sd = {k: v.contiguous() for k, v in chip_smoke.reference_state_dict(params).items()}
    blob = json.loads(json.dumps(dataclasses.asdict(cfg), default=str))
    chip_smoke.write_checkpoint(path, sd, {**blob, "model_type": "vibevoice"})
    monkeypatch.setenv("VIBEVOICE_ALLOW_FALLBACK_TOKENIZER", "1")
    return path


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("int8", [False, True])
def test_from_pretrained_card_matches_cpu(dev, tmp_path, monkeypatch, int8):
    """VibeVoiceTTS.from_pretrained on the card gives the CPU load's tree,
    bit for bit, leaf by leaf: the transfer, the layout changes and (int8)
    the quantization on the card give the CPU's bits."""
    from vibevoice_tpu_torch.tts import VibeVoiceTTS

    path = _tiny_checkpoint(tmp_path / "ckpt", monkeypatch)
    card = VibeVoiceTTS.from_pretrained(str(path), int8=int8)
    cpu = VibeVoiceTTS.from_pretrained(str(path), int8=int8, device="cpu")
    got, want = dict(_leaves(card.params)), dict(_leaves(cpu.params))
    assert sorted(got) == sorted(want) and ("/lm_head_q/w8" in got) == int8
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.cpu().reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), k
    assert set(card.load_walls) == {"read", "transfer", "convert"} | ({"quantize"} if int8 else set())


def test_converters_default_to_the_card(dev, tmp_path, monkeypatch):
    """convert_full_model on the CPU state dict that load_state_dict reads,
    with no device given, builds the tree on the card: the CPU
    conversion's bits."""
    from vibevoice_tpu_torch.configs import VibeVoiceConfig
    from vibevoice_tpu_torch.utils import hf_interop

    path = _tiny_checkpoint(tmp_path / "ckpt", monkeypatch)
    cfg = VibeVoiceConfig.from_json_file(str(path / "config.json"))
    sd = hf_interop.load_state_dict(str(path))
    assert all(v.device.type == "cpu" for v in sd.values())
    got = dict(_leaves(hf_interop.convert_full_model(sd, cfg)))
    want = dict(_leaves(hf_interop.convert_full_model(sd, cfg, device="cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k].cpu(), w), k


def test_safetensors_reader_maps_to_the_card(dev, tmp_path):
    """utils.safetensors_io.load_file(device="cuda") gives card tensors of the
    stored dtypes, equal to the CPU read."""
    import chip_smoke
    from vibevoice_tpu_torch.utils import safetensors_io

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(64, 48, generator=g).to(torch.bfloat16),
               "b": torch.randn(48, generator=g), "q": torch.randint(-127, 128, (16, 8),
                                                                     dtype=torch.int8),
               "s": torch.tensor(1.0)}
    path = str(tmp_path / "shard.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    on_card = safetensors_io.load_file(path, device="cuda")
    for k, v in tensors.items():
        assert on_card[k].device.type == "cuda" and on_card[k].dtype == v.dtype, k
        assert torch.equal(on_card[k].cpu(), v), k


# ---------------------------------------------------------------------------
# Tensor parallelism: the kernels at ranks' local heads; across cards (NCCL)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [(14, 2), (7, 1)])
@pytest.mark.parametrize("w,int8", [(1, False), (1, True), (300, False)])
def test_cached_attention_at_tp_local_heads(dev, heads, w, int8):
    """Kernel B at the 7B's local heads under tensor parallelism (28/4 over
    tp 2: 14/2; over tp 4: 7/1; head_dim 128): a decode row over bf16 and
    int8 caches and a prefill chunk of 300 rows, two samples at other
    bases, against the plain version (1e-2 of the peak)."""
    nh, kh = heads
    g = torch.Generator(device=dev).manual_seed(3)
    s, d = 2048, 128
    q = torch.randn(2, w, nh, d, generator=g, device=dev).to(torch.bfloat16)
    base = torch.tensor([s - w, 517], dtype=torch.int32, device=dev)
    if int8:
        kc, vc = (torch.randint(-127, 128, (2, kh, s, d), generator=g, device=dev).to(torch.int8)
                  for _ in range(2))
        kw = {n: torch.rand(2, kh, 1, s, generator=g, device=dev) / 127
              for n in ("k_scale", "v_scale")}
    else:
        kc, vc = (torch.randn(2, kh, s, d, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kw = {}
    out = fa.flash_cached_attention(q, kc, vc, base, **kw)
    ref = fa.flash_cached_attention_plain(q, kc, vc, base, **kw)
    assert _rel(out, ref) < 1e-2


def test_train_attention_at_tp_local_heads(dev):
    """The training attention at the 1.5B's local heads under tp 2 (6 query
    heads over 1 KV head of 128), f32, right-padded, its tensor-core route:
    O within 1e-4 and dQ/dK/dV within 1e-3 of the plain version's peak."""
    g = torch.Generator(device=dev).manual_seed(4)
    b, t, nh, kh, d = 2, 384, 6, 1, 128
    q = torch.randn(b, t, nh, d, generator=g, device=dev)
    k, v = (torch.randn(b, t, kh, d, generator=g, device=dev) for _ in range(2))
    valid = torch.zeros(b, t, dtype=torch.bool, device=dev)
    valid[0], valid[1, :250] = True, True
    do = torch.randn(b, t, nh, d, generator=g, device=dev) * valid[:, :, None, None]
    assert fa._train_plan(q.dtype, d) == "wgmma"

    def run(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, valid)
        return (out.detach(), *torch.autograd.grad(out, leaves, do))

    got, want = run(fa.flash_train_attention), run(fa.train_attention_plain)
    rows = valid[:, :, None, None]
    assert _rel(got[0] * rows, want[0] * rows) < 1e-4
    for i in (1, 2, 3):
        assert _rel(got[i], want[i]) < 1e-3


def _tp_engine_rank(rank, world, port, seed, out):
    import sys
    from pathlib import Path

    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from vibevoice_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, device_id=torch.device("cuda", rank))
    try:
        res = cs.tp_engine_run(cs.tp_model(seed, device=f"cuda:{rank}"), seed,
                               mesh=make_mesh(dp=1, tp=world))
        logs = [None] * world
        dist.all_gather_object(logs, res["token_log"])
        if rank == 0:
            torch.save({**res, "logs": logs}, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("tp", [2, 4])
def test_multi_card_tp_engine_nccl(dev, tmp_path, tp):
    """ServingEngine(mesh=tp) on the full-width 7B over NCCL, one card a
    rank, graphed (the windows' CUDA graphs capture the all-reduces): every
    rank's window tokens equal, each request's tokens those of the engine
    without a mesh on one card, its audio within chip_smoke.TP_TOL["bf16"]
    of that engine's peak."""
    import sys
    from pathlib import Path

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < tp:
        pytest.skip(f"needs {tp} CUDA devices")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.parallel.mesh import free_port

    _cuda.library()
    ref = cs.tp_engine_run(cs.tp_model(0), 0)
    inf._captures.clear()  # the captures hold the model's tensors
    torch.cuda.empty_cache()
    import time

    out = tmp_path / "rank0.pt"
    ctx = mp.start_processes(_tp_engine_rank, args=(tp, free_port(), 0, str(out)), nprocs=tp,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the tp {tp} world did not finish in 600 s")
    got = torch.load(out, weights_only=False)
    assert got["replays"] > 0
    assert all(len(log) == len(got["logs"][0]) > 0 for log in got["logs"])
    for log in got["logs"][1:]:
        assert all(np.array_equal(a, b) for a, b in zip(log, got["logs"][0]))
    for a, b, ta, tb in zip(got["audio"], ref["audio"], got["tokens"], ref["tokens"]):
        assert ta == tb and a.shape == b.shape
        assert np.abs(a - b).max() <= cs.TP_TOL["bf16"] * np.abs(b).max()


@pytest.mark.parametrize("mesh", [["--mesh_dp", "2", "--fsdp"], ["--mesh_pp", "2"]])
def test_multi_card_fsdp_and_gpipe_steps(dev, tmp_path, mesh):
    """The trainer on the full-width 1.5B (full fine-tuning, f32, B2 T512,
    3 steps) with FSDP over 2 cards and with 2 GPipe stages, over NCCL:
    each step's loss within 1e-4 (relative) of the one-card run's (the
    warmup makes the first update 0, so step 3's loss reads the second)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    repo = Path(__file__).resolve().parents[1]
    common = ["--config", str(repo / "vibevoice_tpu_torch" / "configs" / "qwen2.5_1.5b_64k.json"),
              "--synthetic_data", "--synthetic_items", "4", "--synthetic_seconds", "40", "50",
              "--max_length", "512", "--pad_to_multiple", "512", "--max_steps", "3",
              "--log_steps", "1", "--no_save", "--warmup_steps", "1", "--train_connectors"]

    def losses(extra, batch):
        res = subprocess.run(
            [sys.executable, "-m", "vibevoice_tpu_torch.finetune.train", *common,
             "--per_device_batch_size", str(batch), *extra], cwd=repo, capture_output=True,
            text=True, timeout=600, env={**os.environ, "PYTHONHASHSEED": "0"})
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        return [float(line.split("loss=")[1].split()[0]) for line in res.stdout.splitlines()
                if line.startswith("step ")]

    one = losses([], 2)
    got = losses(mesh, 1 if "--mesh_dp" in mesh else 2)
    assert len(one) == len(got) == 3 and one[2] != one[1]
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, one)), (got, one)


# ---------------------------------------------------------------------------
# The rest of the JAX package's surface: kernel A at the packed, int8-head
# and int8-tokenizer shapes, LM_PACK, the int8 head and tokenizers,
# thresholding, remat_policy="dots", profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,rows", [(1536, 2048, 2), (1536, 17920, 2), (1536, 4608, 20),
                                      (1536, 4608, 80), (3584, 10752, 80), (4608, 1536, 2),
                                      (512, 2048, 1), (8192, 2048, 1), (2048, 8192, 4),
                                      (1024, 4096, 45), (2048, 8192, 300)])
def test_int8_matmul_at_surface_shapes(dev, k, n, rows, dtype):
    """Kernel A at the packed q|k|v and gate|up, the int8 head's FFN and
    AdaLN and the tokenizer FFNs, by both routes: within 1e-2 (bf16) /
    1e-5 (f32) of the plain version, one launch of the route's counter."""
    g = torch.Generator(device=dev).manual_seed(30)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(rows, k, generator=g, device=dev).to(dtype)
    attr = "launches" if rows < quant.GEMM_MIN_ROWS else "launches_tc"
    before = getattr(quant.int8_matmul, attr)
    out = quant.int8_matmul(x, q["w8"], q["scale"])
    assert getattr(quant.int8_matmul, attr) == before + 1
    assert _rel(out, quant.int8_matmul_plain(x, q["w8"], q["scale"])) < (
        1e-2 if dtype == torch.bfloat16 else 1e-5)


def _wide_int8(device, seed=0, pack=False):
    """tiny_config widened to 512 (hidden size, 128 tokenizer filters) on
    ``device``: the int8 LM, lm_head, head and tokenizers (pack=False), or
    the serving packs with the int8 LM's q|k|v and gate|up packed
    (pack=True), f32."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config(hidden_size=512, n_filters=128)
    p = init(cfg, seed=seed, device="cpu")
    for part in (p["acoustic_tokenizer"]["decoder"], p["semantic_tokenizer"]["encoder"]):
        for blk in (b for stage in part["stages"] for b in stage):
            blk["gamma"].fill_(0.3)
            blk["ffn_gamma"].fill_(0.3)
    p = _to(p, device)
    if pack:
        p = vv.quantize_for_inference(p)
        p = {**vv.fuse_for_serving(p, cfg), "lm": quant.pack_lm_projections(p["lm"])}
    else:
        p = vv.quantize_for_inference(p, ("lm", "lm_head", "diffusion_head", "tokenizers"))
    return cfg, p


@pytest.mark.parametrize("pack", [False, True])
def test_surface_card_matches_cpu(dev, pack):
    """The forced generate() (inject mode, K = 4) of the 512-wide config,
    int8 head and tokenizers unfused (A's GEMV at the T = 1 stages) or the
    LM packed: on the card (graphed) against the CPU's plain versions, the
    same tokens and audio within 5e-3 of the peak (chip_smoke.py's
    SMALL_CARD_TOL: summation order alone moves this model's audio ~1e-3 of
    its peak); the card's eager step gives the graphed run's bits."""
    from vibevoice_tpu_torch.models import inference as inf

    cfg, p = _wide_int8(torch.device("cpu"), pack=pack)
    kw = _step_case(cfg, "inject", 4)
    cpu = inf.generate(cfg, p, **kw)
    _, pd = _wide_int8(dev, pack=pack)
    before = quant.int8_matmul.launches
    card = inf.generate(cfg, pd, **kw)
    assert quant.int8_matmul.launches > before
    _assert_same_run(card, cpu, tol=5e-3)
    eager = inf.generate(cfg, pd, **kw, step_fn=_default_step_fn(cfg, kw).eager)
    _assert_same_run(eager, card, tol=0.0)


def test_sample_thresholding_card_matches_cpu(dev):
    """dpm_solver.sample with dynamic thresholding, every algorithm type
    (SDE noise injected): the card's solve within 1e-5 of the CPU's."""
    from vibevoice_tpu_torch.schedule import dpm_solver as dpm

    g = torch.Generator().manual_seed(3)
    w, x0 = torch.randn(32, 32, generator=g), torch.randn(3, 32, generator=g)
    noise = torch.randn(8, 3, 32, generator=g)
    for algo in ("dpmsolver++", "sde-dpmsolver++", "dpmsolver", "sde-dpmsolver"):
        coeffs = dpm.make_solver(8, algorithm_type=algo, final_sigmas_type="zero"
                                 if algo.endswith("++") else "sigma_min")
        outs = []
        for d in (dev, torch.device("cpu")):
            wd = w.to(d)
            outs.append(dpm.sample(coeffs, lambda x, t: 3.0 * torch.tanh(x @ wd) * (
                t[:, None] / 1000 + 0.5), x0.to(d), noise=noise.to(d), thresholding=True,
                dynamic_thresholding_ratio=0.9, sample_max_value=2.5,
                eps_space=not algo.endswith("++")).cpu())
        assert _rel(outs[0], outs[1]) < (5e-4 if algo == "dpmsolver" else 1e-5), algo


def test_dots_qlora_grads_on_the_card(dev):
    """A QLoRA gradient of the tiny config on the card (kernels A, E and the
    training attention) with remat and "dots" against remat alone and no
    remat: the same loss and gradients (1e-6 of each peak)."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.finetune import loss as tloss
    from vibevoice_tpu_torch.finetune import lora as tlora
    from vibevoice_tpu_torch.finetune import train_step as tts
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    p = init(cfg, seed=0, device=dev)
    p = {**p, "lm": quant.quantize_lm(p["lm"])}
    lcfg = tlora.LoraConfig(r=4)
    lora = tlora.init_lora(1, p, lcfg)
    lora = {**lora, "lm_layers": [{k: {"a": v["a"], "b": v["a"].new_full(v["b"].shape, 0.01)}
                                   for k, v in e.items()} for e in lora["lm_layers"]]}
    rng = np.random.RandomState(0)
    b, t, f = 2, 32, 4
    am = np.zeros((b, t), bool)
    am[:, 8:8 + f] = True
    batch = tloss.Batch(rng.randint(10, 100, (b, t)), np.ones((b, t), bool),
                        rng.randn(b, 8 * f).astype(np.float32), np.ones((b, f), bool),
                        rng.randn(b, f, cfg.semantic_vae_dim).astype(np.float32),
                        np.ones((b,), bool), am, am)
    outs = []
    for opts in (dict(remat=True, remat_policy="dots"), dict(remat=True), {}):
        grad_fn = tts.make_lora_grad_fn(cfg, lcfg, tloss.TrainOptions(**opts))
        loss, _, grads = grad_fn(lora, p, batch, torch.Generator(device=dev).manual_seed(5))
        outs.append((float(loss), grads))
    for loss, grads in outs[1:]:
        assert abs(outs[0][0] - loss) <= 1e-6 * abs(loss)
        for path, g_ in grads.items():
            assert _rel(outs[0][1][path], g_) <= 1e-6, path


def test_profiling_trace_records_the_card(dev, tmp_path):
    """utils.profiling.trace on the card: kernel A's launches inside a
    phase show device time, and the phase's name is in the Chrome trace."""
    from vibevoice_tpu_torch.utils import profiling

    q = quant.quantize_weight(torch.randn(1536, 8960, device=dev) * 0.02)
    x = torch.randn(2, 1536, device=dev, dtype=torch.bfloat16)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.phase("vv.decode"):
            for _ in range(4):
                quant.int8_matmul(x, q["w8"], q["scale"])
    assert sum(e.self_device_time_total for e in prof.key_averages()) > 0
    assert any(e.name == "vv.decode" for e in prof.events())
    assert '"vv.decode"' in (tmp_path / "trace.json").read_text()
