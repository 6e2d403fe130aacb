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


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_head_ffn_stack(dev, quantize):
    g = torch.Generator(device=dev).manual_seed(2)
    nb, dim, hid, rows = 3, 128, 384, 2
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    layers = [{"norm": {"w": rn(dim)}, "ffn": {"gate": {"w": rn(dim, hid) / 11},
                                                "up": {"w": rn(dim, hid) / 11},
                                                "down": {"w": rn(hid, dim) / 20}}} for _ in range(nb)]
    packed = hf.pack_head_ffns(layers, 1e-5, quantize)
    x, mods = rn(rows, dim), rn(nb, rows, 3 * dim) * 0.5
    assert _rel(hf.fused_head_ffn_stack(packed, x, mods),
                hf.fused_head_ffn_stack_plain(packed, x, mods)) < 1e-4


@pytest.mark.parametrize("quantize,dtype", [(False, torch.float32), (True, torch.bfloat16)])
def test_fused_stage_step(dev, quantize, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    nb, dim, b = 2, 64, 2
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    blocks = [{"norm": {"w": rn(dim)}, "mixer": {"w": rn(dim, 1, 7) * 0.3, "b": rn(dim) * 0.1},
               "gamma": torch.full((dim,), 0.5, device=dev), "ffn_norm": {"w": rn(dim)},
               "ffn": {"fc1": {"w": rn(dim, 4 * dim) / 8, "b": rn(4 * dim) * 0.1},
                       "fc2": {"w": rn(4 * dim, dim) / 16, "b": rn(dim) * 0.1}},
               "ffn_gamma": torch.full((dim,), 0.5, device=dev)} for _ in range(nb)]
    packed = vf.pack_stage(blocks, 1e-5, quantize)
    if not quantize:  # dense weights in the activation dtype
        packed.arrays["w1"], packed.arrays["w2"] = (packed["w1"].to(dtype), packed["w2"].to(dtype))
    x, st = rn(b, 1, dim).to(dtype), rn(nb, b, 6, dim).to(dtype)
    (y, ns), (yr, nsr) = vf.fused_stage_step(packed, x, st), vf.fused_stage_step_plain(packed, x, st)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel(y, yr) < tol and _rel(ns, nsr) < tol


def test_wrappers_raise_on_unsupported_input(dev):
    x = torch.randn(2, 64, device=dev)
    q = quant.quantize_weight(torch.randn(64, 30, device=dev))  # 30 columns: not a multiple of 4
    with pytest.raises(ValueError):
        quant.int8_matmul(x, q["w8"], q["scale"])
    qq = torch.randn(1, 1, 4, 64, device=dev)
    cache = torch.randn(1, 2, 32, 64, device=dev, dtype=torch.bfloat16)  # dtype differs from q
    with pytest.raises(ValueError):
        fa.flash_cached_attention(qq, cache, cache, torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("rows,k,n,dtype", [(37, 320, 200, torch.float32), (300, 1536, 256, torch.float32),
                                            (130, 96, 1000, torch.bfloat16)])
def test_int8_matmul_t(dev, rows, k, n, dtype):
    """Kernel E (ragged tiles at every edge): the same bf16(g*scale) x int8
    products as the plain version, summed in another order."""
    g = torch.Generator(device=dev).manual_seed(4)
    q = quant.quantize_weight(torch.randn(k, n, generator=g, device=dev))
    gr = torch.randn(rows, n, generator=g, device=dev).to(dtype)
    out = quant.int8_matmul_t(gr, q["w8"], q["scale"])
    assert out.dtype == dtype and out.shape == (rows, k)
    assert _rel(out, quant.int8_matmul_t_plain(gr, q["w8"], q["scale"])) < (
        1e-2 if dtype == torch.bfloat16 else 1e-5)


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
                                       (96, 32, torch.bfloat16)])
def test_flash_train_attention(dev, t, d, dtype):
    """The training attention kernels (forward, dQ/dK/dV) against the plain
    version's autograd on a right-padded GQA batch: outputs on valid rows,
    gradients with dO zero on pad rows (what the loss gives)."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, nh, kh = 2, 6, 2
    q, k, v = (torch.randn(b, t, h, d, generator=g, device=dev).to(dtype) for h in (nh, kh, kh))
    valid = torch.zeros(b, t, dtype=torch.bool, device=dev)
    valid[0, :], valid[1, : t - 37] = True, True
    do = (torch.randn(b, t, nh, d, generator=g, device=dev) * valid[:, :, None, None]).to(dtype)
    res = []
    for fn in (fa.flash_train_attention, fa.train_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, valid)
        res.append((out * valid[:, :, None, None], *torch.autograd.grad(out, leaves, do)))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(*res):
        assert got.dtype == dtype and _rel(got, want) < tol


def test_training_wrappers_raise_on_unsupported_input(dev):
    q = torch.randn(1, 8, 2, 96, device=dev)  # D 96: the kernels take 64 or 128
    seg = torch.ones(1, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fa.flash_train_attention_fwd(q, q, q, seg, 0.1)
    with pytest.raises(ValueError):
        quant.int8_matmul_t(torch.randn(2, 8, device=dev), torch.zeros(4, 8, dtype=torch.int8,
                                                                      device=dev),
                            torch.ones(8, dtype=torch.float64, device=dev))
