"""Parallel paths of the port (port of vibevoice_tpu/parallel/).

A ``torch.distributed`` DeviceMesh stands where the JAX package takes a
``jax.sharding.Mesh``, and every rank is a process holding plain local
shards (the JAX PartitionSpecs are tuples here):

* ``mesh``: ``make_mesh`` ("dp", "tp"), ``make_hybrid_mesh`` ("dcn", "dp",
  "tp"), ``data_axes``, the sharding rules (``qwen2_param_shardings``,
  ``model_param_shardings``, ``fsdp_param_shardings``, ``batch_shardings``,
  ``lora_param_shardings``), ``shard_params`` and ``gather_params``;
* ``collectives``: Megatron's f and g and FSDP's gather, for autograd;
* ``pipeline``: GPipe over a ("dp", "pp") mesh (``make_pp_mesh``,
  ``stack_layers``, ``pipelined_forward``, ``make_pp_lm_forward``);
* ``ring_attention`` and ``sp_prefill``: the sequence-parallel prefill of
  long prompts over the ranks of "tp" (kernel F on each hop).

Tensor-parallel serving and training thread the "tp" group through
``models.qwen2``, ``models.inference``, ``serving.engine`` and
``finetune``. The caller initialises the default process group (NCCL for
CUDA tensors, gloo for CPU tensors) with its address, world size and rank.
"""

from .mesh import (batch_shardings, data_axes, fsdp_param_shardings, gather_params,
                   lora_param_shardings, make_hybrid_mesh, make_mesh, model_param_shardings,
                   qwen2_param_shardings, shard_params)
from .pipeline import make_pp_lm_forward, make_pp_mesh, pipelined_forward, stack_layers, unstack_layers
from .ring_attention import ring_attention, ring_attention_local
from .sp_prefill import ring_prefill_carry

__all__ = ["batch_shardings", "data_axes", "fsdp_param_shardings", "gather_params",
           "lora_param_shardings", "make_hybrid_mesh", "make_mesh", "make_pp_lm_forward",
           "make_pp_mesh", "model_param_shardings", "pipelined_forward", "qwen2_param_shardings",
           "ring_attention", "ring_attention_local", "ring_prefill_carry", "shard_params",
           "stack_layers", "unstack_layers"]
