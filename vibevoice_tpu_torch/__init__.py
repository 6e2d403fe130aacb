"""vibevoice_tpu_torch: the PyTorch/CUDA port of vibevoice_tpu for NVIDIA
Hopper (H100).

Mirrors the JAX package's layout (ops -> schedule -> models -> tts). Plain
tensor code is PyTorch; the four TPU kernels of the serving path are
hand-written CUDA kernels (csrc/*.cu, built at first use by ops/_cuda.py):

  A ops/quant.int8_matmul                      csrc/int8_matmul.cu
  B ops/flash_attention.flash_cached_attention csrc/flash_attention.cu
  C ops/head_fused.fused_head_ffn_stack        csrc/head_ffn.cu
  D ops/vocoder_fused.fused_stage_step         csrc/vocoder_stage.cu

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. The package never imports jax; it reuses the
framework-free ``vibevoice_tpu.configs``, ``.processor`` and ``.streamer``.
"""
