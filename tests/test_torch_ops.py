"""Parity of the PyTorch port's ops against the JAX package on the CPU.

Each kernel's plain PyTorch version (what the port's wrappers run on CPU
tensors) is held against the JAX Pallas kernel in interpret mode; norms,
convs, quantization and the solver against their JAX functions. Inputs come
from numpy seeds. Tolerances: float32 paths agree to summation order
(~1e-6 relative); kernels with bf16 rounding points differ where a sum
lands on a bf16 rounding boundary (one bf16 ulp of the rounded value).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.ops import conv as jconv
from vibevoice_tpu.ops import flash_attention as jfa
from vibevoice_tpu.ops import head_fused as jhf
from vibevoice_tpu.ops import norms as jnorms
from vibevoice_tpu.ops import quant as jquant
from vibevoice_tpu.ops import vocoder_fused as jvf
from vibevoice_tpu.schedule import dpm_solver as jdpm

from vibevoice_tpu_torch.ops import conv as tconv
from vibevoice_tpu_torch.ops import flash_attention as tfa
from vibevoice_tpu_torch.ops import head_fused as thf
from vibevoice_tpu_torch.ops import norms as tnorms
from vibevoice_tpu_torch.ops import quant as tquant
from vibevoice_tpu_torch.ops import vocoder_fused as tvf
from vibevoice_tpu_torch.schedule import dpm_solver as tdpm


def T(a):
    return torch.from_numpy(np.array(a))


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# norms and convs (f32: summation order only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rms", "rms_noweight", "layer"])
def test_norms_match_jax(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype(np.float32) * 3
    w = rng.randn(32).astype(np.float32)
    b = rng.randn(32).astype(np.float32)
    if kind == "layer":
        ref = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
        out = tnorms.layer_norm(T(x), T(w), T(b), 1e-5)
    else:
        wj, wt = (None, None) if kind == "rms_noweight" else (jnp.asarray(w), T(w))
        ref = jnorms.rms_norm(jnp.asarray(x), wj, 1e-6)
        out = tnorms.rms_norm(T(x), wt, 1e-6)
    close(out, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("t,k,stride,groups", [(17, 7, 1, 1), (23, 8, 4, 1), (11, 7, 1, 6)])
def test_causal_conv1d_batch_and_streaming(t, k, stride, groups):
    """Batch conv and chunked streaming (state carried) both match JAX."""
    rng = np.random.RandomState(1)
    cin, cout = 6, 6 if groups > 1 else 5
    x = rng.randn(2, t, cin).astype(np.float32)
    w = rng.randn(k, cin // groups, cout).astype(np.float32)  # JAX TIO
    b = rng.randn(cout).astype(np.float32)
    wt = T(w).permute(2, 1, 0).contiguous()
    ref = jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                              groups=groups)
    close(tconv.causal_conv1d(T(x), wt, T(b), stride=stride, groups=groups), ref, 1e-5, 1e-5)

    ctx = jconv.conv_context_size(k, stride)
    js, ts = jnp.zeros((2, ctx, cin)), torch.zeros(2, ctx, cin)
    n = (t // stride) * stride
    for c0 in range(0, n, 2 * stride):
        chunk = x[:, c0: c0 + 2 * stride]
        yj, js = jconv.causal_conv1d_streaming(jnp.asarray(chunk), js, jnp.asarray(w),
                                               jnp.asarray(b), stride=stride, groups=groups)
        yt, ts = tconv.causal_conv1d_streaming(T(chunk), ts, wt, T(b), stride=stride,
                                               groups=groups)
        close(yt, yj, 1e-5, 1e-5)
        close(ts, js, 0, 0)


def test_conv_transpose1d_batch_and_streaming():
    rng = np.random.RandomState(2)
    k, stride, cin, cout = 8, 4, 5, 3
    x = rng.randn(2, 6, cin).astype(np.float32)
    torch_w = rng.randn(cin, cout, k).astype(np.float32)  # PyTorch (in, out, k)
    jw = torch_w.transpose(2, 0, 1)[::-1].copy()  # the JAX pre-flipped TIO layout
    b = rng.randn(cout).astype(np.float32)
    ref = jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(jw), jnp.asarray(b), stride=stride)
    close(tconv.conv_transpose1d(T(x), T(torch_w), T(b), stride=stride), ref, 1e-5, 1e-5)
    js, ts = jnp.zeros((2, k - 1, cin)), torch.zeros(2, k - 1, cin)
    for f in range(6):
        yj, js = jconv.conv_transpose1d_streaming(jnp.asarray(x[:, f:f + 1]), js, jnp.asarray(jw),
                                                  jnp.asarray(b), stride=stride)
        yt, ts = tconv.conv_transpose1d_streaming(T(x[:, f:f + 1]), ts, T(torch_w), T(b),
                                                  stride=stride)
        close(yt, yj, 1e-5, 1e-5)
        close(ts, js, 0, 0)


# ---------------------------------------------------------------------------
# quantization and kernel A
# ---------------------------------------------------------------------------


def test_quantize_weight_bit_equal():
    rng = np.random.RandomState(3)
    w = rng.randn(96, 40).astype(np.float32) * rng.rand(1, 40).astype(np.float32)
    w[:, 3] = 0.0  # all-zero column -> the 1e-8 scale floor
    ref = jquant.quantize_weight(jnp.asarray(w))
    out = tquant.quantize_weight(T(w))
    np.testing.assert_array_equal(out["w8"].numpy(), np.asarray(ref["w8"]))
    np.testing.assert_array_equal(out["scale"].numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("rows", [2, 16])
def test_int8_matmul_plain_matches_pallas(rows):
    """Kernel A's plain version against the Pallas kernel (interpret) at a
    512-divisible shape, where JAX takes the kernel and not its XLA
    fallback. f32 output: both round x to bf16 and sum exactly-representable
    products in f32, so only the summation order differs."""
    rng = np.random.RandomState(4)
    x = rng.randn(rows, 512).astype(np.float32)
    q = jquant.quantize_weight(jnp.asarray(rng.randn(512, 1024).astype(np.float32)))
    ref = jquant.int8_matmul(jnp.asarray(x), q["w8"], q["scale"], interpret=True)
    out = tquant.int8_matmul(T(x), T(q["w8"]), T(q["scale"]))
    close(out, ref, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,base,quant", [
    (1, [37, 255], False),  # decode; a row at base = S-1
    (1, [255, 100], True),
    (5, [0, 130], False),  # prefill chunks
    (5, [200, 251], True),  # the last row's horizon runs past S
])
def test_flash_plain_matches_pallas(w, base, quant):
    """Kernel B's plain version against the Pallas kernel (interpret), f32
    q, bf16-valued or int8 K/V: the same softmax over the same keys, summed
    in another order."""
    b, nh, kh, s, d = 2, 4, 2, 256, 128
    rng = np.random.RandomState(5)
    q = rng.randn(b, w, nh, d).astype(np.float32)
    k = rng.randn(b, kh, s, d).astype(np.float32)
    v = rng.randn(b, kh, s, d).astype(np.float32)
    base = np.asarray(base, np.int32)
    kw_j, kw_t = {}, {}
    if quant:
        k = np.clip(np.round(k * 40), -127, 127).astype(np.int8)
        v = np.clip(np.round(v * 40), -127, 127).astype(np.int8)
        ks = (rng.rand(b, kh, 1, s) / 40).astype(np.float32)
        vs = (rng.rand(b, kh, 1, s) / 40).astype(np.float32)
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=T(ks), v_scale=T(vs))
    ref = jfa.flash_cached_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(base), block_k=128, interpret=True, **kw_j)
    out = tfa.flash_cached_attention(T(q), T(k), T(v), T(base), **kw_t)
    close(out, ref, 2e-4, 2e-4)


# ---------------------------------------------------------------------------
# kernels C and D
# ---------------------------------------------------------------------------


def _head_layers(rng, n, dim, hid):
    return [{"norm": {"w": rng.randn(dim).astype(np.float32)},
             "ffn": {"gate": {"w": (rng.randn(dim, hid) / np.sqrt(dim)).astype(np.float32)},
                     "up": {"w": (rng.randn(dim, hid) / np.sqrt(dim)).astype(np.float32)},
                     "down": {"w": (rng.randn(hid, dim) / np.sqrt(hid)).astype(np.float32)}}}
            for _ in range(n)]


@pytest.mark.parametrize("quantize,act", [(False, "f32"), (True, "f32"), (True, "bf16")])
def test_head_stack_plain_matches_pallas(quantize, act):
    """Kernel C's plain version against the Pallas kernel (interpret). The
    serving path feeds f32 activations (the solver runs in f32); bf16 adds
    the kernel's bf16 rounding of hmod and the SwiGLU output, where a sum
    near a rounding boundary can land one bf16 ulp apart (atol 2e-2 on O(1)
    outputs)."""
    rng = np.random.RandomState(6)
    nb, dim, hid, rows = 2, 128, 384, 4
    layers = _head_layers(rng, nb, dim, hid)
    x = rng.randn(rows, dim).astype(np.float32)
    mods = (rng.randn(nb, rows, 3 * dim) * 0.5).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if act == "f32" else (jnp.bfloat16, torch.bfloat16)
    jl = jax.tree.map(jnp.asarray, layers)
    ref = jhf.fused_head_ffn_stack(jhf.pack_head_ffns(jl, 1e-5, quantize),
                                   jnp.asarray(x, jdt), jnp.asarray(mods, jdt), interpret=True)
    tl = jax.tree.map(T, layers)
    out = thf.fused_head_ffn_stack(thf.pack_head_ffns(tl, 1e-5, quantize),
                                   T(x).to(tdt), T(mods).to(tdt))
    tol = 1e-5 if act == "f32" else 2e-2
    close(out.float(), np.asarray(ref, np.float32), tol, tol)


def _stage_blocks(rng, nb, dim):
    hid = 4 * dim
    return [{
        "norm": {"w": rng.randn(dim).astype(np.float32)},
        "mixer": {"w": rng.randn(7, 1, dim).astype(np.float32) * 0.3,
                  "b": rng.randn(dim).astype(np.float32) * 0.1},
        "gamma": np.full(dim, 0.5, np.float32),
        "ffn_norm": {"w": rng.randn(dim).astype(np.float32)},
        "ffn": {"fc1": {"w": (rng.randn(dim, hid) / np.sqrt(dim)).astype(np.float32),
                        "b": rng.randn(hid).astype(np.float32) * 0.1},
                "fc2": {"w": (rng.randn(hid, dim) / np.sqrt(hid)).astype(np.float32),
                        "b": rng.randn(dim).astype(np.float32) * 0.1}},
        "ffn_gamma": np.full(dim, 0.5, np.float32),
    } for _ in range(nb)]


@pytest.mark.parametrize("quantize,act", [(False, "f32"), (True, "f32"), (True, "bf16")])
def test_stage_step_plain_matches_pallas(quantize, act):
    """Kernel D's plain version against the Pallas kernel (interpret), two
    frames so the carried conv state is exercised. f32: the TPU kernel's
    polynomial erf (abs error 1.5e-7) against torch's erf. bf16: the FFN
    input, GELU output, state and residual round to bf16 (one bf16 ulp)."""
    rng = np.random.RandomState(7)
    nb, dim, b = 3, 128, 2
    blocks = _stage_blocks(rng, nb, dim)
    jdt, tdt = (jnp.float32, torch.float32) if act == "f32" else (jnp.bfloat16, torch.bfloat16)
    jpk = jvf.pack_stage(jax.tree.map(jnp.asarray, blocks), 1e-5, quantize)
    tblocks = jax.tree.map(T, blocks)
    for blk in tblocks:  # depthwise mixer: JAX TIO (7, 1, C) -> PyTorch (C, 1, 7)
        blk["mixer"]["w"] = blk["mixer"]["w"].permute(2, 1, 0).contiguous()
    tpk = tvf.pack_stage(tblocks, 1e-5, quantize)
    js = jnp.zeros((nb, b, 6, dim), jdt)
    ts = torch.zeros(nb, b, 6, dim, dtype=tdt)
    tol = 2e-5 if act == "f32" else 3e-2
    for f in range(2):
        x = rng.randn(b, 1, dim).astype(np.float32)
        yj, js = jvf.fused_stage_step(jpk, jnp.asarray(x, jdt), js, interpret=True)
        yt, ts = tvf.fused_stage_step(tpk, T(x).to(tdt), ts)
        close(yt.float(), np.asarray(yj, np.float32), tol, tol)
        close(ts.float(), np.asarray(js, np.float32), tol, tol)


def _stream_pass(xs, w, plan):
    """One launch of the streaming core (csrc/weight_stream.cuh) in PyTorch:
    the rows xs (f32, as the loader formed them) against w (K, N), the K axis
    cut into the plan's splits, one f32 partial sum each, the partials met
    as the last block of a column tile meets them (warp j adds splits j,
    j + 4, ... in order, then the 4 warps in order). Raw sums: the caller's
    epilogue or next loader applies the scale."""
    _, splits, kps = plan
    wf = w.float()
    parts = [xs[:, s * kps:(s + 1) * kps] @ wf[s * kps:(s + 1) * kps] for s in range(splits)]
    if splits == 1:
        return parts[0]
    total = torch.zeros_like(parts[0])
    for j in range(4):
        acc = torch.zeros_like(parts[0])
        for sp in range(j, splits, 4):
            acc = acc + parts[sp]
        total = total + acc
    return total


def _block_row_sum(v):
    """Sum over the last axis as a 128-thread block takes it: each thread the
    terms i = t mod 128, the lanes of a warp by a shuffle tree, the 4 warps
    in order."""
    n = v.shape[-1]
    per_thread = torch.nn.functional.pad(v, (0, -n % 128)).reshape(*v.shape[:-1], -1, 128).sum(-2)
    warps = per_thread.reshape(*v.shape[:-1], 4, 32)
    for o in (16, 8, 4, 2, 1):
        warps = warps + torch.roll(warps, o, dims=-1)  # xor-shuffle: every lane ends with the sum
    w = warps[..., 0]
    return ((w[..., 0] + w[..., 1]) + w[..., 2]) + w[..., 3]


def _head_stream_emulated(packed, x, mods):
    """Kernel C's route (csrc/head_ffn.cu) in PyTorch: per layer the gate|up
    pass with the norm and modulation in its loader (the row's sum of
    squares from the block's pre-pass), raw u|v out; the down pass with
    SwiGLU in its loader and the gated residual in its epilogue."""
    dt, dim, hid = x.dtype, packed.dim, packed.hidden
    rows = x.shape[0]
    (wgu, sgu), (wd, sd) = packed.weight("wgu", 0), packed.weight("wd", 0)
    gu, dn = thf._plan(rows, dim, hid, wgu.element_size())
    rnd = lambda v: v.to(dt).float()
    y = x.float()
    for i in range(packed.n_blocks):
        (wgu, sgu), (wd, sd) = packed.weight("wgu", i), packed.weight("wd", i)
        m = mods[i].float()
        ss = _block_row_sum(y * y)[:, None]
        h = y * torch.rsqrt(ss / dim + packed.eps) * packed["norm_w"][i]
        hmod = rnd(h * (1.0 + m[:, dim:2 * dim]) + m[:, :dim])
        uv = _stream_pass(hmod, wgu, gu)
        u, v = uv[:, :hid], uv[:, hid:]
        if sgu is not None:
            u, v = u * sgu[:hid], v * sgu[hid:]
        g = rnd(u / (1.0 + torch.exp(-u)) * v)
        d = _stream_pass(g, wd, dn)
        if sd is not None:
            d = d * sd
        y = rnd(y + m[:, 2 * dim:] * d)
    return y.to(dt)


def _stage_stream_emulated(packed, x, states):
    """Kernel D's route (csrc/vocoder_stage.cu) in PyTorch: per block the
    prologue (norm, depthwise conv, layer-scale residual xmid in f32, norm
    hn), the fc1 pass with bias, exact GELU and rounding in its epilogue, the
    fc2 pass with bias, layer scale and residual in its epilogue."""
    dt, eps, dim, hid = x.dtype, packed.eps, packed.dim, packed.hidden
    a = packed.arrays
    rows = x.shape[0]
    w1, _ = packed.weight("w1", 0)
    p1, p2 = tvf._plan(rows, dim, hid, w1.element_size())
    rnd = lambda v: v.to(dt).float()
    rms = lambda v, w: v * torch.rsqrt(_block_row_sum(v * v)[:, None] / dim + eps) * w
    y = x[:, 0].float()
    new_states = []
    for i in range(packed.n_blocks):
        h = rms(y, a["norm_w"][i])
        st = states[i].float()
        conv = h * a["conv_w"][i, 6] + sum(st[:, t] * a["conv_w"][i, t] for t in range(6))
        new_states.append(torch.cat([states[i][:, 1:], h.to(states.dtype)[:, None]], dim=1))
        xmid = y + (conv + a["conv_b"][i]) * a["gamma"][i]
        hn = rnd(rms(xmid, a["ffn_norm_w"][i]))
        (w1, s1), (w2, s2) = packed.weight("w1", i), packed.weight("w2", i)
        u = _stream_pass(hn, w1, p1) * (1.0 if s1 is None else s1) + a["b1"][i]
        g = rnd(0.5 * u * (1.0 + torch.erf(u * 0.70710678118654752)))
        d = _stream_pass(g, w2, p2) * (1.0 if s2 is None else s2) + a["b2"][i]
        y = rnd(xmid + d * a["ffn_gamma"][i])
    return y.to(dt)[:, None], torch.stack(new_states)


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kernel,dim,hid,rows", [
    ("C", 64, 192, 2), ("C", 256, 768, 3), ("D", 16, 64, 1), ("D", 128, 512, 2)])
def test_head_and_stage_stream_route_matches_plain(kernel, dim, hid, rows, quantize, act):
    """Kernels C and D as they run on the streaming core, emulated in
    PyTorch: split-K partial sums met in the kernel's order, the norm,
    modulation and SwiGLU in C's loaders, bias, GELU, layer scale and
    residuals in the epilogues, the rounding points of the TPU kernels. Held
    against the plain versions (which test_head_stack_plain_matches_pallas
    and test_stage_step_plain_matches_pallas hold against JAX) at
    tiny_config's widths (splits of one) and at wider ones whose K splits
    (2 to 6 slices): 1e-5 in f32 (summation order), 2e-2 in bf16 (a sum next
    to a rounding boundary lands one bf16 ulp away). Dense weights are f32,
    so their plans are those of 4-byte columns."""
    rng = np.random.RandomState(dim + rows)
    dt = torch.float32 if act == "f32" else torch.bfloat16
    tol = 1e-5 if act == "f32" else 2e-2
    if kernel == "C":
        layers = jax.tree.map(T, _head_layers(rng, 2, dim, hid))
        packed = thf.pack_head_ffns(layers, 1e-5, quantize)
        x = T(rng.randn(rows, dim).astype(np.float32)).to(dt)
        mods = T((rng.randn(2, rows, 3 * dim) * 0.5).astype(np.float32)).to(dt)
        out, ref = _head_stream_emulated(packed, x, mods), thf.fused_head_ffn_stack_plain(
            packed, x, mods)
        close(out.float(), ref.float(), tol, tol)
    else:
        blocks = jax.tree.map(T, _stage_blocks(rng, 2, dim))
        for blk in blocks:  # depthwise mixer: JAX TIO (7, 1, C) -> PyTorch (C, 1, 7)
            blk["mixer"]["w"] = blk["mixer"]["w"].permute(2, 1, 0).contiguous()
        packed = tvf.pack_stage(blocks, 1e-5, quantize)
        x = T(rng.randn(rows, 1, dim).astype(np.float32)).to(dt)
        states = T(rng.randn(2, rows, 6, dim).astype(np.float32)).to(dt)
        (y, ns), (yr, nsr) = (_stage_stream_emulated(packed, x, states),
                              tvf.fused_stage_step_plain(packed, x, states))
        close(y.float(), yr.float(), tol, tol)
        close(ns.float(), nsr.float(), tol, tol)


# ---------------------------------------------------------------------------
# DPM-Solver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(algorithm_type="sde-dpmsolver++"),
    dict(solver_order=3, solver_type="heun", timestep_spacing="trailing"),
    dict(algorithm_type="dpmsolver", final_sigmas_type="sigma_min", use_karras_sigmas=True),
])
def test_make_solver_tables_equal(kw):
    for steps in (3, 10, 20):
        ref = jdpm.make_solver(steps, **kw)
        out = tdpm.make_solver(steps, **kw)
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(out, name), np.asarray(getattr(ref, name)),
                                          err_msg=name)


@pytest.mark.parametrize("sde", [False, True])
def test_cfg_sample_with_injected_noise(sde):
    """The CFG solve over a toy head, with per-step extras and injected SDE
    noise, matches the JAX lax.scan (f32, summation order only)."""
    rng = np.random.RandomState(8)
    coeffs_kw = dict(algorithm_type="sde-dpmsolver++" if sde else "dpmsolver++")
    jc, tc = jdpm.make_solver(10, **coeffs_kw), tdpm.make_solver(10, **coeffs_kw)
    b, d, h = 2, 16, 8
    w = rng.randn(d + h, d).astype(np.float32) * 0.3
    cond, uncond = rng.randn(b, h).astype(np.float32), rng.randn(b, h).astype(np.float32)
    x0 = rng.randn(b, d).astype(np.float32)
    extras = rng.randn(10, 2 * b, d).astype(np.float32) * 0.1
    noise = rng.randn(10, b, d).astype(np.float32) if sde else None

    def jhead(x, t, e):
        c = jnp.concatenate([jnp.asarray(cond), jnp.asarray(uncond)])
        return jnp.tanh(jnp.concatenate([x, c], -1) @ jnp.asarray(w)) * (t[:, None] / 1000) + e

    def thead(x, t, e):
        c = torch.cat([T(cond), T(uncond)])
        return torch.tanh(torch.cat([x, c], -1) @ T(w)) * (t[:, None] / 1000) + e

    ref = jdpm.cfg_sample(jc, jhead, jnp.asarray(cond), jnp.asarray(uncond), 1.3,
                          jnp.asarray(x0), noise=None if noise is None else jnp.asarray(noise),
                          extras=jnp.asarray(extras))
    out = tdpm.cfg_sample(tc, thead, T(cond), T(uncond), 1.3, T(x0),
                          noise=None if noise is None else T(noise), extras=list(T(extras)))
    close(out, ref, 1e-5, 1e-5)


def _ring_hops(p_terms, seed=0):
    """Three hops of rank 2 of a 3-ring (Tl 256, G 3, D 128, bf16 inputs)
    through an emulation of the tensor-core kernel F: bf16 Q K^T summed in
    f32, f32 online softmax, and P fed to P V as `p_terms` bf16 terms
    (bf16(p), then bf16 of what is left) against bf16 V with f32 sums; l
    sums the unrounded p. Returns that state and flash_ring_block_plain's."""
    rng = np.random.RandomState(seed)
    b, tl, nh, kh, d, n, rank = 2, 256, 6, 2, 128, 3, 2
    g = nh // kh
    rn = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
    q = rn(b, tl, nh, d)
    blocks = [(rn(b, kh, tl, d), rn(b, kh, tl, d)) for _ in range(n)]
    k_len = torch.tensor([n * tl, 2 * tl + 100], dtype=torch.int32)
    plain = tfa.ring_state_init(b, kh, tl * g, d)
    m, l, acc = tfa.ring_state_init(b, kh, tl * g, d)
    scale = d ** -0.5
    qf = tfa._fold_heads(q.float(), kh)
    for hop in range(n):
        src = (rank - hop) % n
        kb, vb = blocks[src]
        kw = dict(q_start=rank * tl, k_start=src * tl, k_len=k_len)
        tfa.flash_ring_block_plain(plain, q, kb, vb, **kw)
        sc = torch.einsum("bkrd,bksd->bkrs", qf, kb.float())  # raw scores of bf16 inputs
        pos = kw["q_start"] + torch.arange(tl * g) // g
        key = kw["k_start"] + torch.arange(tl)
        live = (key[None, None] <= pos[None, :, None]) & (key[None, None] < k_len[:, None, None])
        sc = sc.masked_fill(~live[:, None], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1) * scale)
        p = torch.exp2((sc * scale - m_new[..., None]) * 1.4426950408889634)
        corr = torch.exp2((m - m_new) * 1.4426950408889634)
        pv, rest = torch.zeros_like(acc), p
        for _ in range(p_terms):
            term = rest.to(torch.bfloat16).float()
            pv = pv + term @ vb.float()
            rest = rest - term
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (m, l, acc), plain


def test_ring_two_term_p_keeps_f32_accuracy():
    """Kernel F on the tensor cores feeds P to the P V product as two bf16
    terms: over three hops its emulation stays within 1e-5 of the peak of
    the plain version's state (m, l and acc), where a single bf16 P misses
    1e-4 on acc, the limit the card holds the kernel to."""
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    (m2, l2, acc2), plain = _ring_hops(2)
    assert rel(m2, plain[0]) < 1e-5 and rel(l2, plain[1]) < 1e-5 and rel(acc2, plain[2]) < 1e-5
    (_, l1, acc1), plain = _ring_hops(1)
    assert rel(l1, plain[1]) < 1e-5  # l sums the unrounded p either way
    assert rel(acc1, plain[2]) > 1e-4


def test_split_bf16_recovers_f32():
    """The split pass of the training attention's tensor-core route
    (split_bf16, which csrc/flash_train.cu's flash_train_split mirrors):
    hi + lo gives x back within 2^-16 of |x|, over a wide exponent range."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(4096) * np.exp2(rng.randint(-30, 30, 4096))).astype(np.float32))
    hi, lo = tfa.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -16 * x.double().abs()).all()


def _mm_terms(a, b, terms):
    """a @ b as the tensor-core route computes it: bf16 hi (and lo) of each
    f32 operand, hi.hi (+ hi.lo + lo.hi) summed in f32."""
    (ah, al), (bh, bl) = ((h.float(), l.float()) for h, l in (tfa.split_bf16(a), tfa.split_bf16(b)))
    out = ah @ bh
    return out + ah @ bl + al @ bh if terms == 3 else out


def test_three_term_product_keeps_f32_accuracy():
    """At D 128, scores Q K^T of f32 operands from three bf16 terms lie
    within 3e-5 of the f64 product, relative to the peak; a single bf16 term
    misses 1e-4, the limit the card holds the attention output to."""
    rng = np.random.RandomState(9)
    q, k = (torch.from_numpy(rng.randn(64, 128).astype(np.float32)) for _ in range(2))
    exact = q.double() @ k.double().T
    rel = lambda terms: float((_mm_terms(q, k.T, terms).double() - exact).abs().max()
                              / exact.abs().max())
    assert rel(3) < 3e-5
    assert rel(1) > 1e-4


def _train_tc_emulated(q, k, v, valid, do, scale):
    """The tensor-core route of csrc/flash_train.cu in plain PyTorch, f32
    operands as three bf16 terms: the forward over _train_walk's key tiles
    with an online softmax (m starting at -1e30), then dK/dV per key tile
    over its query walk and dQ per query tile, P recomputed from the LSE.
    q, k, v, do (B, T, H, D) f32 with the same heads -> (o, dq, dk, dv)."""
    import torch.nn.functional as F

    b, t, h, d = q.shape
    tl = tfa.TRAIN_TILE
    seg = valid.to(torch.int32)
    kfirst, qlast = tfa._train_walk(seg)
    nt = kfirst.shape[1]
    pad = nt * tl - t
    qp, kp, vp, dop = (F.pad(x, (0, 0, 0, 0, 0, pad)).transpose(1, 2) for x in (q, k, v, do))
    segp = F.pad(seg, (0, pad), value=-1)
    pos = torch.arange(nt * tl)
    mm = lambda a, b_: _mm_terms(a, b_, 3)

    def live(bi, r, c):  # (rows, cols) live pairs of query slice r, key slice c
        return ((pos[c][None] <= pos[r][:, None]) & (segp[bi, c][None] == segp[bi, r][:, None])
                & (pos[r] < t)[:, None])

    o = torch.zeros_like(qp)
    lse = torch.zeros(b, h, nt * tl)
    for bi in range(b):
        for qt in range(nt):
            r = slice(qt * tl, qt * tl + tl)
            m, l, acc = torch.full((h, tl), -1e30), torch.zeros(h, tl), torch.zeros(h, tl, d)
            for kt in range(int(kfirst[bi, qt]), qt + 1):
                c = slice(kt * tl, kt * tl + tl)
                s = (mm(qp[bi, :, r], kp[bi, :, c].transpose(1, 2)) * scale).masked_fill(
                    ~live(bi, r, c), float("-inf"))
                mn = torch.maximum(m, s.amax(-1))
                p, corr = torch.exp(s - mn[..., None]), torch.exp(m - mn)
                l, acc, m = l * corr + p.sum(-1), acc * corr[..., None] + mm(p, vp[bi, :, c]), mn
            o[bi, :, r] = acc / l.clamp_min(1e-30)[..., None]
            lse[bi, :, r] = m + torch.log(l.clamp_min(1e-30))
    delta = (dop * o).sum(-1)
    dq, dk, dv = torch.zeros_like(qp), torch.zeros_like(kp), torch.zeros_like(vp)

    def ds_tile(bi, r, c):  # (P, dS) of query slice r and key slice c, queries x keys
        s = mm(qp[bi, :, r], kp[bi, :, c].transpose(1, 2)) * scale
        p = torch.where(live(bi, r, c), torch.exp(s - lse[bi, :, r, None]), 0.0)
        return p, p * (mm(dop[bi, :, r], vp[bi, :, c].transpose(1, 2)) - delta[bi, :, r, None])

    for bi in range(b):
        for kt in range(nt):
            c = slice(kt * tl, kt * tl + tl)
            for qt in range(kt, int(qlast[bi, kt]) + 1):
                r = slice(qt * tl, qt * tl + tl)
                p, ds = ds_tile(bi, r, c)
                dv[bi, :, c] += mm(p.transpose(1, 2), dop[bi, :, r])
                dk[bi, :, c] += mm(ds.transpose(1, 2), qp[bi, :, r]) * scale
        for qt in range(nt):
            r = slice(qt * tl, qt * tl + tl)
            for kt in range(int(kfirst[bi, qt]), qt + 1):
                c = slice(kt * tl, kt * tl + tl)
                dq[bi, :, r] += mm(ds_tile(bi, r, c)[1], kp[bi, :, c]) * scale
    back = lambda x: x.transpose(1, 2)[:, :t]
    return back(o), back(dq), back(dk), back(dv)


@pytest.mark.parametrize("t,lens,d", [(130, (130, 71), 64), (77, (77, 1), 128)])
def test_train_tensor_core_route_matches_plain(t, lens, d):
    """The tensor-core route's arithmetic (three-term products over the
    tile walks, online softmax, FlashAttention-2 backward from the LSE),
    emulated in PyTorch, against train_attention_plain's autograd (held
    against JAX in test_torch_finetune.py) on a right-padded GQA batch:
    outputs on valid rows and the gradients with dO zero on pad rows, 1e-4
    of the peak, the card's limit for the f32 kernels."""
    rng = np.random.RandomState(t)
    b, nh, kh = len(lens), 4, 2
    q, k, v = (torch.from_numpy(rng.randn(b, t, hh, d).astype(np.float32)) for hh in (nh, kh, kh))
    valid = torch.zeros(b, t, dtype=torch.bool)
    for i, n in enumerate(lens):
        valid[i, :n] = True
    do = torch.from_numpy(rng.randn(b, t, nh, d).astype(np.float32)) * valid[:, :, None, None]
    scale = d ** -0.5
    kr, vr = (x.repeat_interleave(nh // kh, dim=2) for x in (k, v))
    o, dq, dk, dv = _train_tc_emulated(q, kr, vr, valid, do, scale)
    dk = dk.reshape(b, t, kh, nh // kh, d).sum(3)  # the GQA repeat's gradient
    dv = dv.reshape(b, t, kh, nh // kh, d).sum(3)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tfa.train_attention_plain(*leaves, valid, scale)
    grads = torch.autograd.grad(ref, leaves, do)
    rel = lambda a, b_: float((a - b_).abs().max() / b_.abs().max())
    rows = valid[:, :, None, None]
    assert rel(o * rows, ref.detach() * rows) < 1e-4
    for got, want in zip((dq, dk, dv), grads):
        assert rel(got, want) < 1e-4
