"""Fine-tuning CLI of the port: ``python -m vibevoice_tpu_torch.finetune.train``
(port of vibevoice_tpu/finetune/train.py).

LoRA (``--use_lora``), QLoRA (``--use_lora --int8_base``: the LM base is
stored int8 and every LM linear runs kernel A forward and kernel E backward)
or full fine-tuning, with CE + diffusion losses, the selective
freeze/unfreeze flags, remat, chunked CE, a diffusion-head position budget,
gradient accumulation, eval, EMA of the diffusion head, pickle checkpoints
and the startup CE smoke check.

Model: ``--model_path <checkpoint dir>`` loads a checkpoint at float32
(utils/hf_interop.load_checkpoint); without it, ``--config <config.json>``
gives that configuration at full width with random weights from ``--seed``;
with neither, a tiny random-weight model (smoke mode). Data:
``--dataset_jsonl`` ({text, audio} lines) or ``--synthetic_data`` (sine-wave
clips). Batches are collated on the host
between steps. It runs on the card (``--device cuda``, the default) and exits
naming ``--device cpu`` where there is none; it never picks the CPU itself.

Meshes, as in the JAX package: ``--mesh_dcn/--mesh_dp/--mesh_tp`` (data
parallel across hosts, data and tensor parallel within one; ``--fsdp``
shards parameters and AdamW moments over the data axis) or ``--mesh_pp``
(GPipe stages, with ``--mesh_dp`` only), with the JAX package's refusals.
One process per rank: under torchrun (``--multihost`` on several hosts:
``torchrun --nnodes N --nproc_per_node P --rdzv_endpoint HOST:PORT -m
vibevoice_tpu_torch.finetune.train --multihost ...``) each process takes
its rank from torchrun's environment; otherwise this command starts the
other ranks of the mesh on this host itself. Rank r uses
``cuda:(LOCAL_RANK mod the cards)``. The ranks talk over NCCL when each
has a card of its own, and over gloo on the CPU or when a host's ranks
outnumber its cards (several ranks share a card; gloo takes no FSDP or
GPipe there). Every rank collates the global batch of
``per_device_batch_size`` times the data shards and keeps its samples;
rank 0 logs and writes the gathered pickle checkpoint.
``--checkpoint_format orbax`` writes sharded checkpoints in the
``torch.distributed.checkpoint`` format instead (utils/checkpoint.py; not
orbax's format), each rank its own shards. ``--report_to wandb`` is refused
(the port does not depend on wandb).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import sys
import time
from typing import Dict

import numpy as np

NO_WANDB = ("--report_to wandb is refused: the port does not depend on wandb (the package "
            "is not part of its environment); metrics go to stdout")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # model
    ap.add_argument("--model_path", type=str, default=None,
                    help="a checkpoint directory (HF-style or native), loaded at float32")
    ap.add_argument("--config", type=str, default=None,
                    help="model config json (e.g. vibevoice_tpu_torch/configs/qwen2.5_1.5b_64k.json): "
                    "that model at full width with random weights from --seed")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; there must be a card) or cpu (the kernels' plain "
                         "versions, for small configs). A mesh's ranks talk over NCCL when each "
                         "has a card, over gloo on the CPU or when a host's ranks outnumber its "
                         "cards (then without --fsdp or --mesh_pp)")
    ap.add_argument("--output_dir", type=str, default="./finetune_out")
    ap.add_argument("--use_lora", action="store_true")
    ap.add_argument("--lora_r", type=int, default=16)
    ap.add_argument("--lora_alpha", type=int, default=32)
    ap.add_argument("--lora_target_modules", nargs="*",
                    default=["q", "k", "v", "o", "gate", "up", "down"])
    ap.add_argument("--train_diffusion_head", action="store_true", default=True)
    ap.add_argument("--lora_full_diffusion_head", action="store_true")
    ap.add_argument("--train_connectors", action="store_true")
    ap.add_argument("--train_acoustic_tokenizer", action="store_true")
    ap.add_argument("--train_semantic_tokenizer", action="store_true")
    ap.add_argument("--train_embed", action="store_true")
    ap.add_argument("--layers_to_freeze", type=str, default=None,
                    help="comma-separated diffusion-head layer indices to freeze")
    ap.add_argument("--lm_layers_to_freeze", type=str, default=None,
                    help="comma-separated LM layer indices to freeze")
    # data
    ap.add_argument("--dataset_jsonl", type=str, default=None, help="jsonl of {text, audio}")
    ap.add_argument("--synthetic_data", action="store_true")
    ap.add_argument("--synthetic_items", type=int, default=64)
    ap.add_argument("--synthetic_seconds", type=float, nargs=2, default=None, metavar=("MIN", "MAX"),
                    help="clip durations of --synthetic_data (default 1-3 s, tiny clips in smoke mode)")
    ap.add_argument("--voice_prompt_drop_rate", type=float, default=0.0)
    ap.add_argument("--max_length", type=int, default=2048)
    ap.add_argument("--pad_to_multiple", type=int, default=None,
                    help="pad the batch's sequence length to a multiple of this")
    # optimization
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=0.01)
    ap.add_argument("--gradient_clipping", type=float, default=1.0)
    ap.add_argument("--warmup_steps", type=int, default=10)
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--per_device_batch_size", type=int, default=2)
    ap.add_argument("--ce_loss_weight", type=float, default=1.0)
    ap.add_argument("--diffusion_loss_weight", type=float, default=1.0)
    ap.add_argument("--ddpm_batch_mul", type=int, default=4)
    ap.add_argument("--ema_decay", type=float, default=0.999)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--save_steps", type=int, default=50)
    ap.add_argument("--log_steps", type=int, default=10)
    ap.add_argument("--eval_steps", type=int, default=0)
    ap.add_argument("--eval_split_size", type=float, default=0.0)
    ap.add_argument("--debug_ce_every_n_steps", type=int, default=0)
    ap.add_argument("--resume_from_checkpoint", type=str, default=None)
    ap.add_argument("--int8_base", action="store_true",
                    help="QLoRA: store the frozen LM base int8 (requires --use_lora)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each LM layer and the diffusion head in the backward")
    ap.add_argument("--ce_chunk_size", type=int, default=0,
                    help="CE in sequence chunks of this many tokens (0 = dense)")
    ap.add_argument("--remat_policy", type=str, default=None, choices=[None, "dots"],
                    help="with --remat: 'dots' keeps the matmul outputs and recomputes the "
                         "rest (a faster backward for more memory)")
    ap.add_argument("--head_budget", type=int, default=0,
                    help="diffusion-head position budget K (0 = every position)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--no_save", action="store_true", help="write no checkpoint")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="run the last step under torch.profiler and write its table of "
                    "kernels by device time here")
    # meshes
    ap.add_argument("--mesh_dcn", type=int, default=1,
                    help="data-parallel replicas across hosts (the slow axis)")
    ap.add_argument("--mesh_dp", type=int, default=1, help="data parallelism within a host")
    ap.add_argument("--mesh_tp", type=int, default=1, help="tensor parallelism within a host")
    ap.add_argument("--mesh_pp", type=int, default=1,
                    help="GPipe pipeline stages (parallel/pipeline.py); composes with "
                         "--mesh_dp, exclusive with --mesh_tp/--mesh_dcn/--fsdp/--use_lora")
    ap.add_argument("--pp_microbatches", type=int, default=2,
                    help="micro-batches per step in the pipeline; per_device_batch_size must "
                         "divide by this")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard parameters and AdamW moments over the data axis on top "
                         "of the TP plan (parallel/mesh.py fsdp_param_shardings); each weight "
                         "is all-gathered at its use, its gradient reduce-scattered")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group from torchrun's environment (one process "
                         "per rank on every host)")
    ap.add_argument("--checkpoint_format", type=str, default="pickle", choices=["pickle", "orbax"],
                    help="orbax = sharded checkpoints, each rank writing its own shards, in "
                         "torch.distributed.checkpoint's format (utils/checkpoint.py; orbax "
                         "itself cannot read them)")
    ap.add_argument("--report_to", type=str, default=None, choices=[None, "wandb"])
    ap.add_argument("--run_name", type=str, default="vibevoice-torch-finetune")
    args = ap.parse_args(argv)
    if args.report_to == "wandb":
        raise SystemExit(NO_WANDB)
    world = args.mesh_dcn * args.mesh_dp * args.mesh_tp * args.mesh_pp
    if args.int8_base and world > 1:
        # the TP/FSDP plans map dense 'w' leaves; int8 QLoRA is the one-device path
        raise SystemExit("--int8_base is a single-chip path (no mesh flags)")
    if args.fsdp and args.mesh_dcn * args.mesh_dp == 1:
        raise SystemExit("--fsdp shards parameters/optimizer state over the data axis; it needs "
                         "--mesh_dp (or --mesh_dcn) > 1 to do anything")
    if args.mesh_pp > 1:
        if args.mesh_tp > 1 or args.mesh_dcn > 1 or args.fsdp or args.use_lora:
            raise SystemExit("--mesh_pp composes only with --mesh_dp (full fine-tune)")
        if args.lm_layers_to_freeze:
            raise SystemExit("--lm_layers_to_freeze is not supported with --mesh_pp")
        if args.per_device_batch_size % args.pp_microbatches:
            raise SystemExit(f"--per_device_batch_size {args.per_device_batch_size} must divide "
                             f"by --pp_microbatches {args.pp_microbatches}")
    return args


def synthetic_dataset(n: int = 64, seed: int = 0, min_dur: float = 1.0, max_dur: float = 3.0):
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        dur = rng.uniform(min_dur, max_dur)
        t = np.arange(max(int(dur * 24_000), 64)) / 24_000
        f = rng.uniform(80, 300)
        wav = (0.1 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        items.append({"text": f"Speaker 1: synthetic sample number {i}", "audio": wav})
    return items


def _build_model(args, device):
    import torch

    from ..configs import VibeVoiceConfig, tiny_config
    from ..processor.processor import VibeVoiceProcessor
    from ..processor.text_tokenizer import QWEN_SPECIAL_IDS, FallbackTextTokenizer

    from ..utils.params import init

    if args.model_path:
        from ..utils.hf_interop import load_checkpoint

        print(f"{args.model_path}: loading the checkpoint at float32")
        return load_checkpoint(args.model_path, dtype="float32", device=device)
    if args.config:
        cfg = VibeVoiceConfig.from_json_file(args.config)
        tk = FallbackTextTokenizer(
            vocab_size=cfg.decoder_config.vocab_size,
            speech_start_id=QWEN_SPECIAL_IDS["speech_start"],
            speech_end_id=QWEN_SPECIAL_IDS["speech_end"],
            speech_diffusion_id=QWEN_SPECIAL_IDS["speech_diffusion"],
            eos_token_id=QWEN_SPECIAL_IDS["eos"], pad_id=QWEN_SPECIAL_IDS["pad"])
        print(f"{args.config}: random weights from seed {args.seed}")
    else:
        print("No --config: tiny random-weight model (smoke mode)")
        cfg = tiny_config()
        tk = FallbackTextTokenizer()
    params = init(cfg, seed=args.seed, dtype=torch.float32, device=device)
    params["speech_scaling_factor"] = torch.tensor(float("nan"), device=device)
    params["speech_bias_factor"] = torch.tensor(float("nan"), device=device)
    processor = VibeVoiceProcessor(tokenizer=tk,
                                   speech_tok_compress_ratio=cfg.acoustic_tokenizer_config.hop_length)
    return cfg, params, processor


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _write_profile(prof, out_dir: str, wall_s: float) -> None:
    """The profiled step's operators and kernels by device self time and the
    device's busy share of the step's wall time (the kernels' summed time
    over the wall; overlapping kernels would count twice)."""
    from torch.autograd import DeviceType

    os.makedirs(out_dir, exist_ok=True)
    events = prof.key_averages()
    # device-side rows: the kernels, and the "vv.*" phase ranges (their span on the device)
    gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in gpu if not e.key.startswith("vv."))
    table = events.table(sort_by="self_device_time_total", row_limit=40, max_name_column_width=70)
    head = (f"step wall {wall_s * 1e3:.1f} ms; kernels {dev_us / 1e3:.1f} ms on the device "
            f"({100 * dev_us / 1e6 / wall_s:.1f}% of the wall)\nphases (span on the device; "
            f"the backward runs on autograd's device thread, outside these ranges):\n")
    for e in sorted((e for e in gpu if e.key.startswith("vv.")),
                    key=lambda e: -e.self_device_time_total):
        head += f"  {e.key:<20s} {e.self_device_time_total / 1e3:10.1f} ms  x{e.count}\n"
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(head + table)
    print(head + table, flush=True)


def _rank_main(argv, env) -> None:
    os.environ.update(env)
    main(argv)


def _start_ranks(argv, world: int) -> list:
    """Ranks 1..world-1 of a one-host mesh as processes running this CLI;
    this process becomes rank 0 (torchrun's environment variables)."""
    import multiprocessing as mp

    from ..parallel.mesh import free_port

    port = str(free_port())
    base = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world)}
    os.environ.update(base, RANK="0", LOCAL_RANK="0")  # main() removes them again
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(argv, {**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
             for r in range(1, world)]
    for proc in procs:
        proc.start()
    return procs


def main(argv=None) -> Dict:
    """Train; returns a summary (per-step losses and seconds, tokens, peak
    device memory)."""
    args = parse_args(argv)
    world = args.mesh_dcn * args.mesh_dp * args.mesh_tp * args.mesh_pp
    procs = []
    if args.multihost and "RANK" not in os.environ:
        raise SystemExit("--multihost takes its rank from torchrun's environment (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT): start it under torchrun")
    if world > 1 and "RANK" not in os.environ:
        procs = _start_ranks(list(sys.argv[1:] if argv is None else argv), world)
    try:
        summary = _train(args, world)
    finally:
        for proc in procs:
            proc.join()
        if procs:  # this process was rank 0 of the ranks it started
            for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK",
                         "LOCAL_RANK"):
                os.environ.pop(name, None)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise SystemExit(f"ranks of the mesh exited with {bad}")
    return summary


def _train(args, world: int) -> Dict:
    import torch
    import torch.distributed as dist

    from ..ops.quant import quantize_lm
    from .data import VibeVoiceCollator, VibeVoiceDataset, make_semantic_encode_fn
    from .ema import init_ema, swap_in_ema, update_ema
    from .loss import TrainOptions
    from .lora import (LoraConfig, copy_tree, init_lora, merge_lora, save_lora_assets, to_numpy,
                       to_torch)
    from .train_step import (
        TrainState,
        build_trainable_filter,
        init_train_state,
        make_eval_step,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
        tree_leaves_with_path,
    )

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; pass --device cpu "
                         "to train on the CPU through the kernels' plain versions")
    rank = 0
    if world > 1 or args.multihost:
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"the mesh flags need {world} ranks; the launcher started "
                             f"{os.environ['WORLD_SIZE']}")
        if cuda:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        # NCCL cannot place two ranks on one card
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", world)) > torch.cuda.device_count()
        backend = "nccl" if cuda and not shared else "gloo"
        if cuda and shared and (args.fsdp or args.mesh_pp > 1):
            raise SystemExit("--fsdp and --mesh_pp need a card a rank (NCCL): gloo, which ranks "
                             "sharing a card use, takes no reduce-scatter or send of CUDA tensors")
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                **({"device_id": device} if backend == "nccl" else {}))
        if rank != 0:  # rank 0 logs
            sys.stdout = open(os.devnull, "w")
    try:
        return _run(args, world, rank, device, cuda)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, world: int, rank: int, device, cuda: bool) -> Dict:
    import torch
    import torch.distributed as dist

    from ..ops.quant import quantize_lm
    from .data import VibeVoiceCollator, VibeVoiceDataset, make_semantic_encode_fn
    from .ema import init_ema, swap_in_ema, update_ema
    from .loss import TrainOptions, split_batch
    from .lora import (LoraConfig, copy_tree, init_lora, merge_lora, save_lora_assets, to_numpy,
                       to_torch)
    from .train_step import (
        OptState,
        Parallel,
        TrainState,
        build_trainable_filter,
        init_train_state,
        make_eval_step,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
        tree_leaves_with_path,
    )

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    np.random.seed(args.seed)
    cfg, params, processor = _build_model(args, device)

    if args.int8_base:
        if not args.use_lora:
            raise SystemExit("--int8_base requires --use_lora (the base is frozen)")
        params = dict(params)
        params["lm"] = quantize_lm(params["lm"])  # the lm_head stays dense
        print("int8 base: LM linears quantized (QLoRA)")

    smoke = args.config is None
    if args.dataset_jsonl:
        with open(args.dataset_jsonl) as f:
            raw = [json.loads(line) for line in f if line.strip()]
    else:
        lo, hi = args.synthetic_seconds or ((0.005, 0.02) if smoke else (1.0, 3.0))
        raw = synthetic_dataset(n=args.synthetic_items, seed=0, min_dur=lo, max_dur=hi)

    eval_raw = []
    if args.eval_split_size > 0:
        n_eval = max(1, int(len(raw) * args.eval_split_size))
        eval_raw, raw = raw[:n_eval], raw[n_eval:]
    dataset = VibeVoiceDataset(raw, seed=args.seed)
    eval_dataset = VibeVoiceDataset(eval_raw, seed=args.seed) if eval_raw else None

    collator = VibeVoiceCollator(
        processor=processor,
        semantic_encode_fn=make_semantic_encode_fn(cfg.semantic_tokenizer_config,
                                                   params["semantic_tokenizer"]),
        max_length=args.max_length,
        speech_compress_ratio=cfg.acoustic_tokenizer_config.hop_length,
        semantic_vae_dim=cfg.semantic_vae_dim,
        voice_prompt_drop_rate=args.voice_prompt_drop_rate,
        pre_silence_sec=0.0005 if smoke else 0.25,
        post_silence_sec=0.0015 if smoke else 0.75,
        crossfade_sec=0.0005 if smoke else 0.25,
        seed=args.seed,
        pad_to_multiple=args.pad_to_multiple,
    )

    opts = TrainOptions(
        ce_loss_weight=args.ce_loss_weight,
        diffusion_loss_weight=args.diffusion_loss_weight,
        ddpm_batch_mul=args.ddpm_batch_mul,
        remat=args.remat,
        ce_chunk_size=args.ce_chunk_size,
        remat_policy=args.remat_policy,
        head_position_budget=args.head_budget,
    )

    def parse_idx(s):
        return tuple(int(x) for x in s.split(",") if x.strip()) if s else ()

    trainable = None
    if not args.use_lora:
        trainable = build_trainable_filter(
            freeze_acoustic_tokenizer=not args.train_acoustic_tokenizer,
            freeze_semantic_tokenizer=not args.train_semantic_tokenizer,
            train_connectors=args.train_connectors,
            train_diffusion_head=args.train_diffusion_head,
            head_layers_to_freeze=parse_idx(args.layers_to_freeze),
            freeze_embed=not args.train_embed,
            lm_layers_to_freeze=parse_idx(args.lm_layers_to_freeze),
        )
    optimizer = make_optimizer(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        grad_clip=args.gradient_clipping, warmup_steps=args.warmup_steps,
        total_steps=args.max_steps, accumulation_steps=args.gradient_accumulation_steps,
        trainable_filter=trainable,
    )

    lora_cfg, lora = None, None
    if args.use_lora:  # drawn from the whole tree, before a mesh cuts it
        lora_cfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                              target_modules=tuple(args.lora_target_modules),
                              train_diffusion_head=args.train_diffusion_head,
                              train_connectors=args.train_connectors,
                              full_diffusion_head=args.lora_full_diffusion_head)
        lora = init_lora(args.seed + 1, params, lora_cfg)
    mesh, par, n_data, data_index = None, None, 1, 0
    if world > 1:
        from ..parallel import mesh as pmesh
        from ..parallel import pipeline as pl

        head_dim = cfg.decoder_config.head_dim
        if args.mesh_pp > 1:
            mesh = pl.make_pp_mesh(pp=args.mesh_pp, dp=args.mesh_dp)
            params = dict(params)
            params["lm"] = pl.stack_layers(params["lm"], args.mesh_pp)
            shardings = pl.pp_model_param_shardings(params)
            lm_forward = pl.make_pp_lm_forward(mesh, n_microbatches=args.pp_microbatches)
            note = f", {args.pp_microbatches} micro-batches"
        else:
            mesh = (pmesh.make_hybrid_mesh(dcn=args.mesh_dcn, dp=args.mesh_dp, tp=args.mesh_tp)
                    if args.mesh_dcn > 1 else pmesh.make_mesh(dp=args.mesh_dp, tp=args.mesh_tp))
            shardings = (pmesh.fsdp_param_shardings(params, mesh, head_dim=head_dim) if args.fsdp
                         else pmesh.model_param_shardings(params, mesh, head_dim))
            lm_forward = None
            note = ", fsdp" if args.fsdp else ""
        axes = pmesh.data_axes(mesh)
        n_data, data_index = pmesh.axis_size(mesh, axes), pmesh.axis_index(mesh, axes)
        tp_shardings = (shardings if args.mesh_pp > 1
                        else pmesh.model_param_shardings(params, mesh, head_dim))
        params = pmesh.shard_params(params, shardings, mesh)
        dims = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh: {dims} ({n_data} data shards{note}; {dist.get_backend()})", flush=True)

    bs = args.per_device_batch_size * n_data  # the global batch

    lora_init = None
    if args.use_lora:
        if mesh is not None:
            lora_shardings = pmesh.lora_param_shardings(lora)
            lora = pmesh.shard_params(lora, lora_shardings, mesh)
            par = Parallel(mesh, lora_shardings, base_shardings=shardings)
        state = init_train_state(lora, optimizer)
        lora_step = make_lora_train_step(cfg, optimizer, lora_cfg, opts, par)
        step_fn = lambda st, batch, rng: lora_step(st, params, batch, rng)
        lora_init = copy_tree(state.params)
    else:
        if mesh is not None:
            par = Parallel(mesh, shardings, lm_forward=lm_forward)
        state = init_train_state(params, optimizer)
        step_fn = make_train_step(cfg, optimizer, opts, trainable_filter=trainable, parallel=par)
    # evaluation reads current_params: the LoRA merge is over the base with
    # its data-axis splits gathered, so it keeps only the TP plan's
    eval_par = None if par is None else Parallel(
        mesh, tp_shardings if args.use_lora else par.shardings, lm_forward=par.lm_forward)
    eval_fn = make_eval_step(cfg, opts, eval_par)

    def current_params(st):
        if not args.use_lora:
            return st.params
        if par is None:
            return merge_lora(params, st.params, lora_cfg)
        from .train_step import gather_for_use

        with torch.no_grad():
            base = gather_for_use(params, par.base_shardings, mesh)
        return merge_lora(base, st.params, lora_cfg, par.groups()["tp_group"])

    # the gathered trees of a checkpoint (collectives: every rank runs them);
    # the EMA head keeps the layout of the head it tracks (a LoRA run's is whole)
    param_specs = None if par is None else par.shardings
    head_specs = None if par is None or args.use_lora else par.shardings["diffusion_head"]

    def gathered(tree, specs):
        return tree if specs is None else pmesh.gather_params(tree, specs, mesh)

    def opt_specs(opt_state):
        from .train_step import _spec_of

        by_path = lambda d: {p: _spec_of(param_specs, p) for p in d}
        return OptState(count=(), mu=by_path(opt_state.mu), nu=by_path(opt_state.nu),
                        mini_step=(), acc=by_path(opt_state.acc))

    def dcp_tree(st, ema_, step):
        return ({"params": st.params, "opt_state": st.opt_state._asdict(), "step": st.step,
                 "ema": ema_, "at": step},
                None if mesh is None else
                {"params": param_specs, "opt_state": opt_specs(st.opt_state)._asdict(),
                 "step": (), "ema": head_specs, "at": ()})

    ema = init_ema(state.params["diffusion_head"] if not args.use_lora
                   else current_params(state)["diffusion_head"])
    start_step = 0
    if args.resume_from_checkpoint:
        if args.checkpoint_format == "orbax":
            from ..utils.checkpoint import restore_train_state

            tree, specs = dcp_tree(state, ema, 0)
            blob = restore_train_state(os.path.join(args.resume_from_checkpoint, "orbax"), tree,
                                       mesh, specs)
            state = TrainState(blob["params"], OptState(**blob["opt_state"]), int(blob["step"]))
            ema, start_step = blob["ema"], int(blob["at"])
        else:
            with open(os.path.join(args.resume_from_checkpoint, "train_state.pkl"), "rb") as f:
                blob = pickle.load(f)
            st = blob["state"]
            p_, o_, e_ = (to_torch(st["params"], device), to_torch(st["opt_state"], device),
                          to_torch(blob["ema"], device))
            if mesh is not None:  # the full trees, cut to this rank's layout
                o_ = OptState(**o_)
                specs = opt_specs(o_)
                o_ = o_._replace(mu=pmesh.shard_params(o_.mu, specs.mu, mesh),
                                 nu=pmesh.shard_params(o_.nu, specs.nu, mesh),
                                 acc=pmesh.shard_params(o_.acc, specs.acc, mesh))._asdict()
                p_ = pmesh.shard_params(p_, param_specs, mesh)
                if head_specs is not None:
                    e_ = pmesh.shard_params(e_, head_specs, mesh)
            state = TrainState(p_, OptState(**o_), int(st["step"]))
            ema, start_step = e_, int(blob["step"])
        print(f"Resumed from step {start_step}")

    rng = torch.Generator(device=device).manual_seed(args.seed + 2)

    def local(batch):
        return batch if n_data == 1 else split_batch(batch, n_data, data_index)

    def collate(items):
        """The collated global batch, on every rank as rank 0 made it (the
        fallback tokenizer's ids depend on each process's str hash salt)."""
        if mesh is None:
            return collator(items)
        box = [collator(items) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    # startup CE smoke check: one collated batch must give a finite CE
    probe = collate([dataset[i % len(dataset)] for i in range(bs if mesh is not None
                                                              else min(bs, len(dataset)))])
    probe_out = eval_fn(current_params(state), local(probe),
                        torch.Generator(device=device).manual_seed(0))
    ce0 = float(probe_out.ce_loss)
    if not math.isfinite(ce0):
        raise SystemExit("startup CE smoke test failed (non-finite)")
    print(f"startup smoke: ce={ce0:.4f} over {int(probe_out.ce_token_count)} tokens, "
          f"{int(probe_out.speech_frame_count)} diffusion frames")

    def save(step):
        out = os.path.join(args.output_dir, f"checkpoint-{step}")
        if rank == 0:
            os.makedirs(out, exist_ok=True)
        if args.checkpoint_format == "orbax":
            from ..utils.checkpoint import save_train_state

            if mesh is not None:
                dist.barrier()
            tree, specs = dcp_tree(state, ema, step)
            save_train_state(os.path.join(out, "orbax"), tree, mesh, specs)
        else:
            opt = state.opt_state
            if mesh is not None:
                specs = opt_specs(opt)
                opt = opt._replace(mu=gathered(opt.mu, specs.mu), nu=gathered(opt.nu, specs.nu),
                                   acc=gathered(opt.acc, specs.acc))
            st_params, ema_full = gathered(state.params, param_specs), gathered(ema, head_specs)
            if rank == 0:
                with open(os.path.join(out, "train_state.pkl"), "wb") as f:
                    pickle.dump({"state": {"params": to_numpy(st_params),
                                           "opt_state": to_numpy(opt._asdict()),
                                           "step": state.step},
                                 "ema": to_numpy(ema_full), "step": step}, f)
        if args.use_lora:
            lora_full = gathered(state.params, param_specs)
            if rank == 0:
                save_lora_assets(os.path.join(out, "lora"), lora_full, lora_cfg)
        else:  # the EMA head swapped in at export, the list layout of the layers
            export = swap_in_ema(gathered(state.params, param_specs), gathered(ema, head_specs))
            if args.mesh_pp > 1:
                export = dict(export)
                export["lm"] = pl.unstack_layers(export["lm"])
            if rank == 0:
                with open(os.path.join(out, "params.pkl"), "wb") as f:
                    pickle.dump(to_numpy(export), f)
        if mesh is not None:
            dist.barrier()
        print(f"saved {out}")

    steps_per_epoch = max(1, len(dataset) // bs)
    order_cache: Dict[int, np.ndarray] = {}

    def build_batch(step):
        """The global batch of `step`: a per-epoch seeded permutation, so
        resuming gives the same batches."""
        epoch = step // steps_per_epoch
        if epoch not in order_cache:
            order_cache.clear()
            order_cache[epoch] = np.random.RandomState(args.seed + epoch).permutation(len(dataset))
        order = order_cache[epoch]
        idx = order[(step * bs) % len(order): (step * bs) % len(order) + bs]
        if len(idx) < bs:
            idx = order[:bs]
        batch = collate([dataset[int(i)] for i in idx])
        if args.head_budget:
            per_sample = int(np.asarray(batch.acoustic_loss_mask).sum(axis=1).max())
            if per_sample > args.head_budget:
                raise SystemExit(f"--head_budget {args.head_budget} < {per_sample} target frames "
                                 "in a sample; raise the budget or crop targets")
        return batch

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    for step in range(start_step, args.max_steps):
        t0 = time.perf_counter()
        global_batch = build_batch(step)
        batch = local(global_batch)
        t1 = time.perf_counter()
        sync()
        prof = _profiler(cuda) if args.profile_dir and step == args.max_steps - 1 else None
        t2 = time.perf_counter()
        if prof is not None:
            with prof:
                state, out = step_fn(state, batch, rng)
                sync()
        else:
            state, out = step_fn(state, batch, rng)
            sync()
        sec = time.perf_counter() - t2
        if prof is not None:
            _write_profile(prof, args.profile_dir, sec)
        head = current_params(state)["diffusion_head"]
        if (step + 1) % args.gradient_accumulation_steps == 0:
            ema = update_ema(ema, head, args.ema_decay)
        b, t = np.asarray(global_batch.input_ids).shape
        rec = dict(step=step + 1, loss=float(out.loss), ce_loss=float(out.ce_loss),
                   diffusion_loss=float(out.diffusion_loss), seconds=sec, data_seconds=t1 - t0,
                   batch=b, seq_len=t, tokens=b * t,
                   valid_tokens=int(np.asarray(global_batch.attention_mask).sum()))
        records.append(rec)

        if args.use_lora and step == start_step and args.gradient_accumulation_steps == 1:
            flat_a = [x for _, x in tree_leaves_with_path(lora_init)]
            flat_b = [x for _, x in tree_leaves_with_path(state.params)]
            changed = sum(int(not torch.allclose(a, b)) for a, b in zip(flat_a, flat_b))
            print(f"lora debug: {changed}/{len(flat_b)} adapter tensors changed after step 1")
            if changed == 0:
                print("WARNING: no LoRA adapter changed after the first step")

        if args.debug_ce_every_n_steps and (step + 1) % args.debug_ce_every_n_steps == 0:
            print(f"  ce-debug step {step + 1}: {int(out.ce_token_count)} CE tokens, "
                  f"max token CE {float(out.ce_max):.3f}, argmax acc {float(out.ce_accuracy):.3f}, "
                  f"{int(out.speech_frame_count)} diffusion frames")

        if eval_dataset is not None and args.eval_steps and (step + 1) % args.eval_steps == 0:
            eval_params = current_params(state)
            losses = []
            for e0 in range(0, len(eval_dataset), bs):
                items = [eval_dataset[j] for j in range(e0, min(e0 + bs, len(eval_dataset)))]
                items += [eval_dataset[0]] * (bs - len(items))
                eo = eval_fn(eval_params, local(collate(items)),
                             torch.Generator(device=device).manual_seed(1234))
                losses.append((float(eo.ce_loss), float(eo.diffusion_loss)))
            print(f"  eval step {step + 1}: ce={sum(x for x, _ in losses) / len(losses):.4f} "
                  f"diffusion={sum(x for _, x in losses) / len(losses):.4f}")

        if (step + 1) % args.log_steps == 0 or step == start_step:
            print(f"step {step + 1}/{args.max_steps} loss={rec['loss']:.4f} "
                  f"ce={rec['ce_loss']:.4f} diff={rec['diffusion_loss']:.4f} "
                  f"({sec:.3f} s/step, {b}x{t} tokens, {b * t / sec:.0f} tokens/s)", flush=True)
        if not args.no_save and (step + 1) % args.save_steps == 0:
            save(step + 1)

    if not args.no_save and (args.max_steps % args.save_steps != 0 or start_step >= args.max_steps):
        save(args.max_steps)
    peaks = [torch.cuda.max_memory_allocated(device) if cuda else None]
    if mesh is not None:  # every rank's, for rank 0's log
        gathered_peaks = [None] * world
        dist.all_gather_object(gathered_peaks, peaks[0])
        peaks = gathered_peaks
    if cuda:
        print(f"peak device memory {peaks[0] / 2**30:.2f} GiB ({torch.cuda.get_device_name(device)})"
              + ("" if mesh is None else
                 "; per rank " + ", ".join(f"{p / 2**30:.2f}" for p in peaks) + " GiB"))
    print("done")
    lora = None
    if args.use_lora:  # the whole adapters (a collective under a mesh)
        lora, lora_init = gathered(state.params, param_specs), gathered(lora_init, param_specs)
    return dict(device=str(device), steps=records, lora=lora, lora_init=lora_init, rank=rank,
                peak_bytes=peaks[0], peak_bytes_per_rank=peaks)


if __name__ == "__main__":
    main()
