"""vibevoice_tpu_torch: the PyTorch/CUDA port of vibevoice_tpu for NVIDIA
Hopper (H100).

Mirrors the JAX package's layout (ops -> schedule -> models -> tts,
finetune, parallel). Plain tensor code is PyTorch; every TPU kernel of the
JAX package is a hand-written CUDA kernel (csrc/*.cu, built at first use by
ops/_cuda.py):

  A ops/quant.int8_matmul                      csrc/int8_matmul.cu (GEMV, few rows)
                                               csrc/int8_gemm.cu (wgmma GEMM, many rows)
  B ops/flash_attention.flash_cached_attention csrc/flash_decode.cu (decode, f32 q)
                                               csrc/flash_prefill.cu (bf16 chunks, W > 1)
  C ops/head_fused.fused_head_ffn_stack        csrc/head_ffn.cu
  D ops/vocoder_fused.fused_stage_step         csrc/vocoder_stage.cu
  E ops/quant.int8_matmul_t                    csrc/int8_matmul_t.cu (cast + wgmma GEMM)
  F ops/flash_attention.flash_ring_block       csrc/flash_ring.cu
  training attention (fwd, bwd)                csrc/flash_train.cu (wgmma at head_dim 64/128,
                                               CUDA cores at 16/32)

A's GEMV, C and D run on one core, csrc/weight_stream.cuh: a one-launch
GEMV that streams an int8, bf16 or f32 weight once, with the loader and the
epilogue (norms, modulation, activations, residuals) fused in.

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. The package imports neither jax nor anything of the
JAX package ``vibevoice_tpu``: it keeps its own copies of the framework-free
``configs`` (with ``configs/qwen2.5_1.5b_64k.json``), ``processor`` and
``streamer``.
"""
