"""Parallel paths of the port (port of vibevoice_tpu/parallel/, in part).

The sequence-parallel (ring-attention) prefill of long prompts:
``mesh.make_mesh`` builds a ``torch.distributed`` DeviceMesh with dims
("dp", "tp") where the JAX package builds a ``jax.sharding.Mesh``;
``ring_attention`` rotates K/V shards around the ranks of its "tp" group,
folding each through kernel F (``ops.flash_attention.flash_ring_block``);
``sp_prefill.ring_prefill_carry`` runs the Qwen2 prefill sequence-sharded and
returns the ``inference.DecodeCarry`` that the decode step takes. The
caller initialises the default process group (NCCL for CUDA tensors, gloo
for CPU tensors) with its address, world size and rank.
"""

from .mesh import make_mesh
from .ring_attention import ring_attention, ring_attention_local
from .sp_prefill import ring_prefill_carry

__all__ = ["make_mesh", "ring_attention", "ring_attention_local", "ring_prefill_carry"]
