#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vibevoice_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--frames N] [--out DIR]

Run from the root of a checkout; it needs one CUDA device and the CUDA
toolkit (nvcc), and exits non-zero without a result otherwise.

Phases, each of which fails the run:
  1. device: CUDA present; prints the card's name and power limit;
  2. build: compiles the kernels from the nine sources in
     vibevoice_tpu_torch/csrc/ (one nvcc per source, all at once), ten
     entries of the kernels line (and their "@7b" twins, phase 12): A
     int8_matmul by its two routes (the one-launch streaming GEMV below
     quant.GEMM_MIN_ROWS rows, the tensor-core GEMM int8_matmul_gemm from
     there up), B flash_cached_attention by its two routes (flash-decoding at
     W = 1 and for f32 q, the tensor-core flash_cached_attention_prefill for
     bf16 chunks), C fused_head_ffn_stack, D fused_stage_step, E
     int8_matmul_t, F flash_ring_block, and the training attention's forward
     and backward (their tensor-core route; ptxas' registers and spills of
     its kernels are printed);
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the 1.5B serving, sequence-parallel prefill and
     fine-tuning paths give it, with the stated tolerance, plus CUDA times
     of both, the bound (the larger of the bytes over 3.35 TB/s and the
     operations over the peak rate for their type: 989 TFLOP/s bf16 on the
     tensor cores, 67 TFLOP/s f32) and, where one PyTorch call computes the
     same function, that call's time (library_ms; the port never calls it).
     Kernel F runs the four hops of rank 2 of a 4-way ring over a
     16,384-token prompt (the last block wholly in the future, which must
     leave the state bit-identical) and the one hop of a world of one;
     kernel A runs at 1, 2, 4, 8, GEMM_MIN_ROWS - 1, 512, 4,096 (f32) and
     32,768 rows at the four LM shapes (the GEMV rows twice, bit-identical,
     and one CUDA-graph capture of the 2-row call replayed with new x), and
     both of its routes from 4 to 256 rows (the crossover);
     kernel B at the decode over 4,096-, 65,536- and 32,768-slot caches,
     full and at a low fill (the serving run's, and 300 of 65,536), as
     replays of one CUDA-graph capture with three other bases written in
     place, and over chunks of 512 and 2,048 rows; kernel B again at the
     streaming 0.5B's shapes (14 query heads over 2 KV heads, head_dim 64,
     one sample): decode over 8,192 bf16 slots at a 36-frame stream's fill
     and full (one CUDA-graph capture replayed with three other bases) and
     over 16,384 int8 slots, the prefill route at W = 5 (a text window) and
     W = 256 from base 0 (the voice preset); kernels C and D at the
     1.5B head's and vocoder stage's widths with int8 and bf16 weights, each
     with the device kernels of one call counted and timed by pass by
     torch.profiler (at most 12 and 24 kernels), a repeat that must give the
     same bits and one CUDA-graph capture replayed with new inputs; kernel E
     at 4,096 f32 rows at the four LM shapes and at 8,192 at gate/up and
     down, with its cast pass and its GEMM also timed apart; the training
     attention (f32, B 2 T 2048 and B 1 T 8192, right-padded) with its f32
     bound beside the bound of the products its design computes (three bf16
     terms each, plus the split pass's bytes), the split pass timed apart,
     and SDPA's forward and its autograd backward as the library times;
     and at the rows of the batched serving paths (check_batched_kernels):
     C at 8 rows (int8 and bf16 weights), D at 4 and 8 rows, B's decode
     route at 8 rows of mixed bases with an idle row past the cache (the
     1.5B at 4,096 bf16 and 65,536 int8 slots, the 0.5B at 8,192 for each
     of its two caches), each also captured in a CUDA graph and replayed on
     new inputs against its eager call (the same bits), as is A's GEMV at 8
     rows;
  4. end to end, serving: the full-width 1.5B model (random weights from
     --seed, bf16, int8 LM + lm_head, fuse_for_serving) runs generate() on a
     two-speaker script with two 3 s voice prompts and a forced script of
     speech frames, at max_length 4096 (bf16 KV) and 65536 (int8 KV), with
     K = 1 and 4 frames a window: the default generate(), which captures the
     step of K frames in a CUDA graph once and replays it, then the same
     runs through that step function's eager call. Graphed and eager must
     give identical tokens, audio within GRAPH_TOL of the peak and equal
     launch counts; every serving kernel must have launched, the graphed
     runs must have replayed a graph, and the audio must be finite and
     non-silent; per-frame ms and RTF are printed for each. Then the
     default generate() with nothing injected (do_sample, top_p 0.9, SDE;
     host-drawn latents, noise and uniforms) for three windows of K = 4 at
     4096, and one such window from one prefilled carry, graphed against
     eager (identical tokens; audio, every frame's in the window, within
     GRAPH_TOL). torch.profiler then records one replay of a 17-frame
     window (busy share, top kernels, idle gaps); each port kernel's device
     kernels in it must equal those of the same window run eagerly, whose
     wrapper calls must equal the launches the capture recorded. A
     tiny-config generate() also runs twice, once on the card (graphed) and
     once on the CPU through the plain versions, and the two must agree;
  5. end to end, sequence-parallel prefill: in a one-rank NCCL group (file
     store under build/), the same model prefills a batch of two
     right-padded prompts of 16,384 and 12,000 tokens (the script repeated,
     the two voice prompts spliced in) with parallel.ring_prefill_carry, at
     max_length 32768 (bf16 KV) and 65536 (int8 KV); each carry is held
     against inference.chunked_prefill (kernel B's prefill route on chunks
     of 2048, kernel A's GEMM) on the same prompt (cache lengths, h_pos, the
     valid cache of layers 0 and 27, limits in SP_TOL) and decodes 8 forced
     frames through the graphed make_step_fn (8 replays), which must be
     finite and non-silent;
     kernels F, A (both routes), B (decode), C and D must all have launched
     in the ring run, and A's GEMM and B's prefill route in chunked_prefill;
  6. end to end, the streaming 0.5B model: the full-width config from
     vibevoice_tpu_torch/configs/qwen2.5_0.5b_streaming.json (24 layers
     split 4 + 20, hidden 896, 14/2 heads of 64, FFN 4864, vocab 151936,
     diffusion head 896 x 4, the full acoustic decoder), random bf16 weights
     from --seed, fuse_vocoder(quantize=True); a voice preset prefilled from
     a random 256-token prompt at 8,192 slots; StreamingTTS.stream() at its
     default options (cfg 1.5, 5 DDPM steps) on a ~40-token script. Random
     weights give a random EOS, so the timed streams set the EOS
     classifier's output bias to -30 and stop through stop_check_fn after 6
     windows (36 frames). After warmup(), which captures the text and speech
     windows, it prints the time to first audio, ms a frame and RTF graphed
     and eager (the windows' eager calls), and one replayed text and speech
     window's device time by CUDA events. Graphed and eager must give the
     same audio within GRAPH_TOL of the peak and equal launch counts, kernel
     B (both routes) and D must launch, the audio must be finite and not
     silent; a run with the bias at +30 must stop after the first frame of
     the first window, and a stream at 16,384 slots (int8 KV) must complete;
  7. end to end, fine-tuning: a tiny-config QLoRA gradient and two
     optimizer steps on the card through the kernels against the same on
     the CPU through the plain versions; then the port's trainer (finetune/train.py) fine-tunes the
     full-width 1.5B with QLoRA (int8 LM base, LoRA r 16 on all seven LM
     targets and the diffusion head, f32 activations, random weights from
     --seed, synthetic clips): 3 steps at B 2, T 2048, then 2 steps at B 1,
     T 8192 with remat and CE chunks of 1024. Losses finite, adapters moved
     after step 2, kernels A (its GEMM), E and the training attention's
     tensor-core route launched, its CUDA-core route never (the tiny
     config's head_dim 16 takes that one);
  8. end to end, the serving engine: serving.ServingEngine(max_batch=4,
     max_len=4096, frames_per_dispatch=4, reserved_slots=1) over phase 4's
     model made to speak (utils.params.speaking), after warmup(): eight
     requests of the two-speaker prompt and voices capped at 40 frames
     (four at once, one with priority; four staggered, one cancelled)
     must end as expected with their audio and agree with stats(); the
     request in slot 3 against itself alone in the engine (GRAPH_TOL) and
     against its batch-1 run on the same noise rows (tokens equal, audio
     within ENGINE_SOLO_TOL); one batched window
     replayed against eager (the same bits and launches); eight requests at
     once at max_batch 4 against max_batch 1 (audio seconds a wall second),
     TTFA, a replay's device time a frame; four requests at 65,536 slots
     (int8 KV);
  9. end to end, the session engine: StreamingSessionEngine(n_slots=8,
     max_len=8192, quantum=3) over phase 6's model (EOS held off): 12
     sessions of the script (4 queued) and a live one fed in three parts,
     each capped at 36 frames; join-TTFA, quantum walls against their
     real-time budget, the aggregate real-time factor; one inject-mode
     session batched with three others against itself alone in the engine
     (GRAPH_TOL) and its solo generate() (SESSION_SOLO_TOL);
 10. end to end, HTTP: serving/server.py's build_server over phases 8's
     and 9's engines, in this process on port 0: /health, /tts,
     /tts/stream, /v1/audio/speech (wav, pcm, an error), /tts/rt plain and
     live with /append and /end, /stats; status codes, WAV headers and PCM
     lengths checked;
 11. end to end from checkpoints (checkpoint_end_to_end): the 1.5B's and
     the 0.5B's random weights written as reference-layout checkpoints
     (bf16 safetensors shards with an index) under build/phase11, loaded by
     VibeVoiceTTS / StreamingTTS.from_pretrained (int8 and the serving packs
     for the 1.5B) bit-equal to the random-weight trees; phase 4's forced
     generate() on the loaded 1.5B gives phase 4's tokens and audio bits
     through kernels A-D, a 36-frame stream() of the loaded 0.5B gives
     StreamingTTS.random's bits through B and D; the load's walls, host
     RSS and card memory are printed; both file CLIs run once as
     subprocesses (the streaming one on that checkpoint, the multi-speaker
     one on the 1.5B's weights made to speak, written the same way) and
     must write audio; the files are removed at the end;
 12. the 7B (vibevoice_tpu_torch/configs/qwen2.5_7b_32k.json: hidden 3584,
     28 query heads over 4 KV heads of 128, FFN 18944, an untied lm_head of
     152,064 x 3584, a 3584-10752-3584 diffusion head, 32,768 positions) at
     full width, random weights from --seed (the_7b): (a) every kernel at its
     shapes against its plain version (phase 3's tolerances), timed with its
     bound and library call and replayed from a CUDA graph against its eager
     call (the same bits): A's GEMV at 2 and 8 rows (the LM linears and the
     lm_head) and A's GEMM at 16,384 rows, B's decode at 4,096 bf16 and
     32,768 int8 slots and its prefill route on a 2,048-row chunk, C, D, E
     at 2,048 f32 rows, F over 16,384 tokens, the training attention at B1
     T2048; (b) VibeVoiceTTS.random on the 7B JSON: phase 4's forced script
     at 4,096 bf16 slots, graphed (K = 4) against eager (the same tokens,
     audio within GRAPH_TOL), and the profile of one replayed 17-frame
     window; (c) a 16,384-token prompt by chunked_prefill and the world-of-
     one ring prefill into a 32,768-slot int8 cache, held together, then 32
     graphed frames; (d) ServingEngine(max_batch=4, max_len=4096,
     frames_per_dispatch=4) over the 7B made to speak, eight 40-frame
     requests at once, the request in slot 3 against itself alone in the
     engine (GRAPH_TOL); (e) the trainer, --config <7B> --use_lora
     --int8_base, B1 T2048, 3 steps (finite losses, s/step, peak memory);
     (f) the 7B cut to 4 layers at full width (~7.4 GB bf16, untied
     lm_head.weight) as a reference-layout checkpoint, loaded by
     from_pretrained(int8=True) bit-equal to VibeVoiceTTS.random's tree.
     The kernels line's "<kernel>@7b" entries hold (a)'s main-path cases
     and the launches of (b)-(e);
 13. tensor parallelism on the one card (tensor_parallel): (a) kernel B at
     the 7B's local heads under TP (14/2 at tp 2, 7/1 at tp 4: decode over
     4,096 bf16 and 32,768 int8 slots; the prefill route on a 2,048-row
     chunk, bf16 and int8) and the training attention at the 1.5B's tp 2
     heads (6/1, B2 T2048), each against its plain version, timed with its
     bound and SDPA, and replayed from a CUDA graph against its eager call
     (the "<kernel>@tp" entries); (b) the 7B with a dense bf16 LM and the
     serving packs, made to speak, through ServingEngine(mesh=<tp 1>,
     max_batch=4, max_len=4096, frames_per_dispatch=4) in a world of one
     over NCCL, graphed (the graph captures the all-reduces), against the
     same engine without a mesh (four requests of TP_ENGINE_FRAMES frames,
     the initial latents from one bank by slot: the same tokens, audio
     within GRAPH_TOL), then phase 4's forced script at 4,096 bf16 and
     32,768 int8 slots (the references of (c)); (c) two ranks on the one
     card over gloo (eager windows; this process is rank 0): the engine's
     four requests (the same tokens on both ranks and as tp 1's) and the
     forced script at both lengths, held against (b) (the same tokens;
     h_pos and the cache of layers 0 and 27 within TP_TOL; the audio's
     drift printed), and three planted faults over two windows (the o
     shards swapped between ranks, layer 0's attention all-reduce skipped,
     the KV heads swapped), each of which must read TP_FAULT_FACTOR times
     the limit; then the trainer on the full-width 1.5B (--use_lora over
     the dense f32 base, B2 T1024, 3 steps) on one rank, under --mesh_tp 2
     and --mesh_dp 2 (gloo, both ranks on the card): step 1's loss within
     TP_TRAIN_TOL of one rank's, s/step and the peak memory of each rank;
     a tp 2 train state (the 7B's layer-0 attention shards, AdamW moments)
     saved and restored through utils/checkpoint must come back bit-equal;
     (d) it prints which
     multi-card cases (FSDP, GPipe, the graphed NCCL engine at tp 2 and 4,
     in tests/test_torch_cuda.py) the machine's cards could not run;
 14. the rest of the JAX package's surface (the_surface): (a) kernel A at
     the packed q|k|v and gate|up, int8-head and int8-tokenizer shapes of
     the 1.5B and the 7B (SURFACE_KERNELS), each against its plain version,
     timed with its bound and torch.mm, replayed from a CUDA graph against
     its eager call (the same bits); (b) VibeVoiceTTS.random with LM_PACK=1
     against phase 4's model: h_pos after the prefill the same bits, the
     forced graphed run's tokens equal, ms a frame and a replayed window's
     device time of both taken in turn; (c) the 512-wide int8 LM, head and
     tokenizers on the card against the CPU (SMALL_CARD_TOL), and the
     full-width 1.5B so (graphed against eager, the same bits; no C or D
     launch) beside the fused path, then utils.profiling.trace around one
     graphed window; (d) sample(thresholding=True) on the card against
     the CPU; (e) QLoRA B2 T2048 with remat and with remat_policy dots (the
     same losses; peak memory and s/step); (f) the merge script on phase
     11's checkpoint with (e)'s adapters, and the QA harness on it (its
     parity step skipped with its reason where the upstream reference does
     not import). Phase 12 (g) runs the 7B packed with an int8 head.
The next-to-last line is a JSON object of the kernels' results
(thirty entries: the ten of phases 3-11, their "@7b" twins, the four "@tp"
entries of B's two routes and the training attention, and kernel A's six
surface entries, "@pack", "@head", "@tok" by route and the 7B's "@pack@7b"
and "@head@7b"); the last line is the JSON device record. The script runs itself again with
PYTHONHASHSEED=0: the prompts go through the hash-bucket fallback
tokenizer, so every run of one --seed then feeds the model the same ids;
and with TEARDOWN_CUPTI=0 and DISABLE_CUPTI_LAZY_REINIT=1, so that its many
profiles beside captured CUDA graphs keep recording device activity. A
failed check prints its reason on stdout and on stderr and exits 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG_1P5B = ROOT / "vibevoice_tpu_torch" / "configs" / "qwen2.5_1.5b_64k.json"
CONFIG_0P5B = ROOT / "vibevoice_tpu_torch" / "configs" / "qwen2.5_0.5b_streaming.json"
CONFIG_7B = ROOT / "vibevoice_tpu_torch" / "configs" / "qwen2.5_7b_32k.json"
VOICE_SECONDS = 3.0  # length of each synthetic voice prompt
# Limits of the ring prefill against chunked_prefill (h_pos and the cache of
# layers 0 and 27, as max |diff| over the peak), by KV type. The two paths
# round bf16 at other places, so 28 layers drift apart. On an H100 with
# --seed 0 (the same reading in every process): h_pos 2.59e-2, layer 27
# 2.98e-2 (bf16 KV); h_pos 4.12e-2, layer 27 6.10e-2 (int8 KV, where
# chunked_prefill attends through the quantized cache). Planted faults read
# 0.67 and above: RoPE one slot late (caches), h_pos one slot early, scores
# not scaled by head_dim ** -0.5. One does not show here: the last valid
# key dropped (k_len - 1) reads 3.1e-2 / 3.6e-2, inside the sound spread,
# since random-weight attention over 16K keys is nearly uniform. The length
# and causal masks are held by the kernel phase (kernel F against its plain
# version at 1e-4) and by the CPU tests against JAX, not by this limit.
SP_TOL = {"bf16": 1e-1, "int8": 1.5e-1}
# Kernel B's decode bases at the serving run's last frame (end_to_end prints
# them): the positive stream holds the 105-token prompt plus 32 frames, the
# negative CFG stream restarts at speech_start and holds 16.
SERVING_FILL = (137, 16)
# The streaming 0.5B phase: a voice preset from a 256-token prompt at the
# StreamingTTS default of 8,192 cache slots, and timed streams of 6 windows
# (36 frames). Kernel B's decode cases at the 0.5B's shapes sit at the fill
# of such a stream (the preset plus 30 frames) and at a full cache.
STREAM_PRESET = 256
STREAM_MAX_LEN = 8192
STREAM_WINDOWS = 6
STREAM_FILL = STREAM_PRESET + 30
STREAM_SCRIPT = ("Welcome back to the show. Today we talk about streaming speech synthesis, where "
                 "the first words are already spoken while the rest of the sentence is still being "
                 "written, and the listener never waits for the whole paragraph to be ready.")


# Published dense peaks of one H100 SXM (NVIDIA's data sheet): the bound of
# a kernel is the larger of its operations over the peak for their type and
# its bytes (each input read once, each output written once) over HBM's rate.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak: str = "bf16") -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes")."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS[peak] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def counters() -> dict:
    """Each kernel entry's launch count as (wrapper, attribute), as the
    wrappers register them (ops/_cuda.py LAUNCH_COUNTERS): kernels A and B
    count their two routes in two attributes of one wrapper. The training
    attention's CUDA-core route (D 16, 32; "..._cores") is not an entry of
    the kernels line: the fine-tune at D 128 must never take it."""
    from vibevoice_tpu_torch.ops import _cuda
    from vibevoice_tpu_torch.ops import flash_attention, head_fused  # noqa: F401
    from vibevoice_tpu_torch.ops import quant, vocoder_fused  # noqa: F401

    return _cuda.LAUNCH_COUNTERS


def reset_counts(names) -> None:
    for name in names:
        setattr(*counters()[name], 0)


def read_counts(names) -> dict:
    return {name: getattr(*counters()[name]) for name in names}


def ptxas_report(log: str, prefix: str) -> list:
    """One line per kernel whose (mangled) name holds `prefix` and "_tc":
    its template arguments, registers and spill stores, from ptxas -v."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if prefix in m.group(1) and "_tc" in m.group(1) else None
            args = re.search(r"(" + prefix + r"[a-z_]+_tc)ILi(\d+)ELb(\d)E", name or "")
            if args:
                name = f"{args.group(1)}<{args.group(2)}, {'f32' if args.group(3) == '1' else 'bf16'}>"
        elif name and "bytes spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        elif name and "Used" in ln:
            out.append(f"{name}: {re.search(r'Used (\d+) registers', ln).group(1)} registers, "
                       f"{spill} bytes spilled")
            name = None
    return out


def fail(msg: str) -> None:
    """Report on both streams (a caller that keeps only the end of stderr
    still reads why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_ms(fn, operands, iters: int = 20) -> float:
    """Device time of one fn(op) call: `iters` calls, cycling through
    `operands`, are captured into one CUDA graph, and the median over five
    replays (timed with CUDA events) is divided by `iters`. Host launch
    overhead is thereby left out; it is reported end to end instead."""
    import torch

    for i in range(3):  # warm-up outside the capture
        fn(operands[i % len(operands)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(operands[i % len(operands)])
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[len(times) // 2]


def rel_err(out, ref) -> tuple[float, float]:
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-6)


class Checks:
    """Collects the per-case comparisons; each kernel's JSON entry keeps its
    worst error and the times of its main-path case, and every timed case
    is kept for the --out record. While ``tag`` is set (phase 12: "@7b")
    the cases go to the entries ``<kernel><tag>``, the kernels at another
    configuration's shapes."""

    def __init__(self):
        self.kernels: dict = {}
        self.cases: list = []
        self.extra: dict = {}
        self.tag = ""

    def case(self, kernel: str, label: str, out, ref, tol_rel: float, ms=None, plain_ms=None,
             main: bool = False, bound=None, library_ms=None) -> None:
        """`bound` is (ms, "bytes" or "operations") from bound(); library_ms
        the time of one PyTorch call computing the same function, if any."""
        import torch

        kernel += self.tag
        if not torch.isfinite(out.float()).all():
            fail(f"{kernel} {label}: non-finite output")
        err, rel = rel_err(out, ref)
        timing = "" if ms is None else f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
        if ms is not None and bound is not None:
            timing += f"  bound {bound[0]:.4g} ms ({bound[1]}, {bound[0] / ms:.1%} of it)"
        if ms is not None and library_ms is not None:
            timing += f"  library {library_ms:.4f} ms"
        print(f"  {kernel:<24s} {label:<40s} max_abs_err {err:.3e}  rel {rel:.3e} "
              f"(tol {tol_rel:.0e}){timing}", flush=True)
        k = self.kernels[kernel]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if ms is not None:
            self.cases.append(dict(kernel=kernel, case=label, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound and bound[0], bound_by=bound and bound[1],
                                   library_ms=library_ms, max_abs_err=err, rel_err=rel,
                                   main=main))
        if main:
            k["ms"], k["plain_ms"] = ms, plain_ms
            k["bound_ms"], k["bound_by"] = bound
            k["library_ms"] = library_ms
        if not rel <= tol_rel:
            fail(f"{kernel} {label}: relative error {rel:.3e} above {tol_rel:.0e}")


def rotating(make, nbytes: int, budget: int = 160 << 20):
    """Enough copies of an operand that cycling through them streams from
    HBM (the 50 MB L2 holds none of them between uses), as on the serving
    path where 28 layers' weights pass between two uses of one."""
    return [make() for _ in range(max(1, min(16, math.ceil(budget / max(nbytes, 1)))))]


LM_SHAPES = (("q/o", 1536, 1536), ("k/v", 1536, 256), ("gate/up", 1536, 8960),
             ("down", 8960, 1536))  # (name, IN, OUT) of the 1.5B decoder's int8 linears


def check_int8_matmul(checks: Checks, label: str, x, ws: list, tol: float, main: bool = False,
                      iters: int = 20, timer=None) -> None:
    """Kernel A on x against its plain version, both timed with the weights
    in `ws` rotating, beside torch.mm on bf16 copies of the same weights."""
    import torch

    from vibevoice_tpu_torch.ops import quant

    rows, (k, n) = x.shape[0], ws[0]["w8"].shape
    w = ws[0]
    if timer is None:
        timer = lambda fn, ops: bench_ms(fn, ops, iters=iters)
    out = quant.int8_matmul(x, w["w8"], w["scale"])
    ref = quant.int8_matmul_plain(x, w["w8"], w["scale"])
    ms = timer(lambda w: quant.int8_matmul(x, w["w8"], w["scale"]), ws)
    pms = timer(lambda w: quant.int8_matmul_plain(x, w["w8"], w["scale"]), ws)
    wbs = [(w["w8"].float() * w["scale"]).to(torch.bfloat16) for w in ws]
    xb = x.to(torch.bfloat16)
    lms = timer(lambda wb: torch.mm(xb, wb), wbs)
    del wbs
    route = quant._plan(rows, k, n).route
    if route == "gemv" and not torch.equal(quant.int8_matmul(x, w["w8"], w["scale"]), out):
        fail(f"int8_matmul {label}: two calls on the same inputs differ")
    byt = nbytes(x, w["w8"], w["scale"]) + rows * n * x.element_size()
    checks.case("int8_matmul_gemm" if route == "gemm" else "int8_matmul", label, out, ref, tol, ms,
                pms, main=main, bound=bound(2 * rows * k * n, byt), library_ms=lms)


def gemv_graph_check(checks: Checks, label: str, x, w: dict) -> None:
    """Kernel A's GEMV call captured once in a CUDA graph, then replayed
    with new x written in place into the captured tensor; each replay
    against the plain version (tol 1e-2)."""
    import torch

    from vibevoice_tpu_torch.ops import quant

    quant.int8_matmul(x, w["w8"], w["scale"])  # the workspace outside the capture
    torch.cuda.synchronize()
    before = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant.int8_matmul(x, w["w8"], w["scale"])
    for i in range(3):
        x.copy_(torch.roll(before, i + 1, dims=1) * (i + 2))
        graph.replay()
        torch.cuda.synchronize()
        checks.case("int8_matmul", f"{label} CUDA-graph replay {i + 1}", out,
                    quant.int8_matmul_plain(x, w["w8"], w["scale"]), 1e-2)
    x.copy_(before)
    del graph


def decode_graph_check(checks: Checks, q, kc, vc, base, bases, label: str = "") -> None:
    """Kernel B's decode call captured once in a CUDA graph, then replayed
    with each of `bases` written in place into the captured base tensor;
    each replay against the plain version at those bases (tol 1e-2)."""
    import torch

    from vibevoice_tpu_torch.ops import flash_attention as fa

    before = base.clone()
    fa.flash_cached_attention(q, kc, vc, base)  # workspace and counters outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_cached_attention(q, kc, vc, base)
    for new in bases:
        base.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        checks.case("flash_cached_attention", f"{label}W=1 S={kc.shape[2]} bf16 CUDA-graph replay "
                    f"base={list(new)}", out, fa.flash_cached_attention_plain(q, kc, vc, base),
                    1e-2)
    base.copy_(before)
    del graph


def check_cached_attention(checks: Checks, g, heads: tuple, w: int, s: int, int8: bool,
                           base: tuple, main: bool = False, label: str = "",
                           graph_bases=None, graph_bits: bool = False) -> None:
    """Kernel B at one shape against its plain version (tol 1e-2), both
    timed, with its bound and, over a bf16 cache, SDPA's time (the prefix
    mask, enable_gqa) beside them. heads = (q heads, KV heads, head_dim);
    one sample per entry of `base`. With `graph_bases` the decode call is
    also captured in a CUDA graph and replayed at those bases; with
    `graph_bits` the call is replayed from a capture on new q and rolled
    bases against eager calls (the same bits)."""
    import torch
    import torch.nn.functional as F

    from vibevoice_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    nh, kh, d = heads
    nb = len(base)
    q = torch.randn((nb, w, nh, d), generator=g, device=dev).to(torch.bfloat16)
    base_t = torch.tensor(base, dtype=torch.int32, device=dev)
    if int8:
        kc = torch.randint(-127, 128, (nb, kh, s, d), generator=g, device=dev).to(torch.int8)
        vc = torch.randint(-127, 128, (nb, kh, s, d), generator=g, device=dev).to(torch.int8)
        ks = torch.rand((nb, kh, 1, s), generator=g, device=dev) / 127
        vs = torch.rand((nb, kh, 1, s), generator=g, device=dev) / 127
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = (torch.randn((nb, kh, s, d), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kw = {}
    if graph_bases:
        decode_graph_check(checks, q, kc, vc, base_t, graph_bases, label)
    out = fa.flash_cached_attention(q, kc, vc, base_t, **kw)
    ref = fa.flash_cached_attention_plain(q, kc, vc, base_t, **kw)
    big = w * s >= 512 * 65536  # the plain version's scores are 3-6 GB here
    ms = bench_ms(lambda _: fa.flash_cached_attention(q, kc, vc, base_t, **kw), [None])
    pms = bench_ms(lambda _: fa.flash_cached_attention_plain(q, kc, vc, base_t, **kw), [None],
                   iters=3 if big else 20)
    lms = None
    if not int8:
        mask = (base_t[:, None, None, None] + torch.arange(w, device=dev)[:, None]
                >= torch.arange(s, device=dev))  # (B, 1, W, S): key j live for row i
        qt = q.transpose(1, 2)
        lms = bench_ms(lambda _: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask,
                                                                enable_gqa=True), [None])
        del mask
    # causal work of these bases: row i of sample b sees min(base + i + 1, S) keys
    keys = [min(b_ + i + 1, s) for b_ in base for i in range(w)]
    kv_rows = sum(min(b_ + w, s) for b_ in base) * kh  # live cache rows, read once
    flops = 4 * d * nh * sum(keys)
    byt = nbytes(q) * 2 + nbytes(base_t) + kv_rows * d * 2 * kc.element_size() + (
        kv_rows * 2 * 4 if int8 else 0)
    kernel = "flash_cached_attention_prefill" if w > 1 else "flash_cached_attention"
    case = f"{label}W={w} S={s} {'int8' if int8 else 'bf16'} base={list(base)}"
    checks.case(kernel, case, out, ref, 1e-2, ms, pms, main=main, bound=bound(flops, byt),
                library_ms=lms)
    if graph_bits:
        del out, ref
        before = base_t.clone()
        graph_vs_eager(checks, kernel, case,
                       lambda: fa.flash_cached_attention(q, kc, vc, base_t, **kw), (q,),
                       tweak=lambda i: (base_t.copy_(torch.roll(before, i + 1)), q.mul_(1.5)))
        base_t.copy_(before)


def head_layers(randn, dim: int, hid: int, n_layers: int) -> list:
    """Random diffusion-head FFN layers for kernel C (randn draws bf16)."""
    return [{"norm": {"w": 1 + 0.1 * randn(dim)},
             "ffn": {"gate": {"w": randn(dim, hid) * 0.03}, "up": {"w": randn(dim, hid) * 0.03},
                     "down": {"w": randn(hid, dim) * 0.02}}} for _ in range(n_layers)]


def stage_blocks(randn, dim: int, n_blocks: int) -> list:
    """Random Block1D blocks of one vocoder stage for kernel D."""
    import torch

    half = lambda: torch.full((dim,), 0.5, dtype=torch.bfloat16, device="cuda")
    return [{"norm": {"w": 1 + 0.1 * randn(dim)},
             "mixer": {"w": randn(dim, 1, 7) * 0.3, "b": randn(dim) * 0.1},
             "gamma": half(), "ffn_norm": {"w": 1 + 0.1 * randn(dim)},
             "ffn": {"fc1": {"w": randn(dim, 4 * dim) * 0.02, "b": randn(4 * dim) * 0.1},
                     "fc2": {"w": randn(4 * dim, dim) * 0.01, "b": randn(dim) * 0.1}},
             "ffn_gamma": half()} for _ in range(n_blocks)]


def check_kernels(checks: Checks, seed: int) -> None:
    import torch

    from vibevoice_tpu_torch.ops import head_fused as hf
    from vibevoice_tpu_torch.ops import quant
    from vibevoice_tpu_torch.ops import vocoder_fused as vf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device=dev).to(dt)

    # A: every int8 LM linear shape of the 1.5B decoder, decode rows (2 at bs1
    # with both CFG streams, 4 after the ring prefill, 8 at bs4) and prefill rows
    print("kernel A int8_matmul (bf16 x, int8 w, f32 scale; bf16 out: tol 1e-2 of the peak; "
          "library: torch.mm on a bf16 copy of the weight)")
    for name, k, n in LM_SHAPES:
        ws = rotating(lambda: quant.quantize_weight(randn(k, n, dt=torch.float32) * 0.02), k * n)
        for rows in (1, 2, 4, 8, quant.GEMM_MIN_ROWS - 1, 512):
            x = randn(rows, k)
            check_int8_matmul(checks, f"{name} {k}x{n} rows={rows}", x, ws, 1e-2,
                              main=(name == "gate/up" and rows == 2))
            if rows in (2, 8):
                gemv_graph_check(checks, f"{name} {k}x{n} rows={rows}", x, ws[0])
            if rows == 8:
                graph_vs_eager(checks, "int8_matmul", f"{name} {k}x{n} rows=8",
                               lambda: quant.int8_matmul(x, ws[0]["w8"], ws[0]["scale"]), (x,))

    # A's two routes side by side, to place the row threshold of quant._plan
    print(f"kernel A routes by rows (bf16 x; ms of the GEMV / the GEMM; quant.GEMM_MIN_ROWS = "
          f"{quant.GEMM_MIN_ROWS})")
    sweep = (4, 8, 12, 16, 24, 32, 36, 40, 48, 64, 128, 256)
    crossover, layer = {}, {r: [0.0, 0.0] for r in sweep}
    for name, k, n in LM_SHAPES:
        ws = rotating(lambda: quant.quantize_weight(randn(k, n, dt=torch.float32) * 0.02), k * n)
        times = []
        for rows in sweep:
            x = randn(rows, k)
            times.append((rows, bench_ms(lambda w: quant._gemv(x, w["w8"], w["scale"]), ws),
                          bench_ms(lambda w: quant._gemm(x, w["w8"], w["scale"]), ws)))
            per_layer = 1 if name == "down" else 2  # q, k, v, o, gate, up, down
            layer[rows][0] += per_layer * times[-1][1]
            layer[rows][1] += per_layer * times[-1][2]
        wins = [r for r, tv, tg in times if all(g <= v for rr, v, g in times if rr >= r)]
        crossover[f"{name} {k}x{n}"] = dict(rows_gemm_wins_from=wins[0] if wins else None,
                                             times=times)
        print(f"  {name:<8s} " + "  ".join(f"{r}: {tv:.4f}/{tg:.4f}" for r, tv, tg in times)
              + f"  -> GEMM from {wins[0] if wins else 'never'}", flush=True)
        del ws
    wins = [r for r in sweep if all(layer[rr][1] <= layer[rr][0] for rr in sweep if rr >= r)]
    crossover["layer (2 q/o + 2 k/v + 2 gate/up + down)"] = dict(
        rows_gemm_wins_from=wins[0] if wins else None,
        times=[(r, *layer[r]) for r in sweep])
    print("  layer    " + "  ".join(f"{r}: {v:.4f}/{g:.4f}" for r, (v, g) in layer.items())
          + f"  -> GEMM from {wins[0] if wins else 'never'}", flush=True)
    checks.extra["int8_matmul_route_crossover"] = crossover

    # B: the decoder's GQA layout (12 q heads, 2 KV heads, D=128), one row
    # per sample and CFG stream (2B); the S=32768 case is the decode after the
    # ring prefill of a 16,384- and a 12,000-token prompt (positive streams,
    # then the negative ones); the low-fill cases hold the serving run's fill
    # (SERVING_FILL) and a 65,536-slot cache filled to 300, whose time must
    # not grow with S; W=2048 is the last chunk of chunked_prefill on the same
    # two prompts
    print("kernel B flash_cached_attention (bf16 q; bf16 or int8 KV; bf16 out: tol 1e-2; library: "
          "scaled_dot_product_attention with the prefix mask and enable_gqa, bf16 KV only)")
    for w, s_, int8, base in ((1, 4096, False, (4095, 1234)), (1, 4096, False, SERVING_FILL),
                              (1, 65536, True, (65535, 300)), (1, 65536, True, (300, 300)),
                              (1, 32768, False, (16384, 12000, 1, 1)),
                              (512, 4096, False, (4095, 1000)), (512, 65536, True, (65535, 20000)),
                              (2048, 32768, False, (14336, 12000))):
        first = (w, s_, int8, base) == (1, 4096, False, (4095, 1234))
        check_cached_attention(checks, g, (12, 2, 128), w, s_, int8, base,
                               main=(w, s_, base) in ((1, 4096, (4095, 1234)),
                                                      (2048, 32768, (14336, 12000))),
                               graph_bases=((0, 4095), SERVING_FILL, (3000, 17)) if first else None)

    # C: 4 head layers, 1536 -> 4608 -> 1536; the solver runs the head in f32
    print(f"kernel C fused_head_ffn_stack (f32 x and mods (2B=2 rows); int8 or bf16 weights: "
          f"tol 1e-4; at most {FUSED_MAX_KERNELS['fused_head_ffn_stack']} device kernels a call)")
    dim, hid, nl = 1536, 4608, 4
    for quantize in (True, False):
        layers = head_layers(randn, dim, hid, nl)
        packs = rotating(lambda: hf.pack_head_ffns(layers, 1e-5, quantize),
                         3 * nl * dim * hid * (1 if quantize else 2), budget=120 << 20)
        x = randn(2, dim, dt=torch.float32)
        mods = randn(nl, 2, 3 * dim, dt=torch.float32) * 0.5
        w = "int8" if quantize else "bf16"
        call = lambda: hf.fused_head_ffn_stack(packs[0], x, mods)
        out = call()
        ref = hf.fused_head_ffn_stack_plain(packs[0], x, mods)
        ms = bench_ms(lambda pk: hf.fused_head_ffn_stack(pk, x, mods), packs)
        pms = bench_ms(lambda pk: hf.fused_head_ffn_stack_plain(pk, x, mods), packs)
        # no single PyTorch call computes a stack of norm + modulation + SwiGLU layers
        checks.case("fused_head_ffn_stack", f"{nl} layers {w} weights", out, ref, 1e-4, ms, pms,
                    main=quantize,
                    bound=bound(2 * 2 * 3 * dim * hid * nl,
                                nbytes(*packs[0].arrays.values(), x, mods, out), "f32"))
        fused_call_checks(checks, "fused_head_ffn_stack", f"{nl} layers {w} weights", call,
                          lambda: hf.fused_head_ffn_stack_plain(packs[0], x, mods), (x, mods),
                          1e-4)

    # D: 8 Block1D blocks at 2048 -> 8192 -> 2048, one bf16 frame (B=1)
    print(f"kernel D fused_stage_step (bf16 x and state; int8 or bf16 weights: tol 2e-2; at most "
          f"{FUSED_MAX_KERNELS['fused_stage_step']} device kernels a call)")
    dim, nb = 2048, 8
    for quantize in (True, False):
        blocks = stage_blocks(randn, dim, nb)
        packs = rotating(lambda: vf.pack_stage(blocks, 1e-5, quantize),
                         nb * 8 * dim * dim * (1 if quantize else 2), budget=120 << 20)
        x, st = randn(1, 1, dim), randn(nb, 1, 6, dim)
        call = lambda: vf.fused_stage_step(packs[0], x, st)
        (out, ns), (ref, rs) = call(), vf.fused_stage_step_plain(packs[0], x, st)
        ms = bench_ms(lambda pk: vf.fused_stage_step(pk, x, st), packs)
        pms = bench_ms(lambda pk: vf.fused_stage_step_plain(pk, x, st), packs)
        w = "int8" if quantize else "bf16"
        # no single PyTorch call computes a stack of Block1D steps
        checks.case("fused_stage_step", f"{nb} blocks {w} weights: y", out, ref, 2e-2, ms, pms,
                    main=quantize,
                    bound=bound(2 * nb * (8 * dim * dim + 7 * dim),
                                nbytes(*packs[0].arrays.values(), x, st, out, ns)))
        checks.case("fused_stage_step", f"{nb} blocks {w} weights: new state", ns, rs, 2e-2)
        fused_call_checks(checks, "fused_stage_step", f"{nb} blocks {w} weights", call,
                          lambda: vf.fused_stage_step_plain(packs[0], x, st), (x, st), 2e-2)


def graph_vs_eager(checks: Checks, kernel: str, label: str, call, inputs, tweak=None,
                   eager=None) -> None:
    """A kernel's call captured once in a CUDA graph and replayed twice
    with new inputs written in place (`tweak(i)`, or each input rolled and
    scaled): each replay must give the bits of an eager call on the same
    inputs (`eager`, by default `call`: a call that updates its outputs in
    place passes one writing to other tensors). The inputs are restored
    afterwards."""
    import torch

    tup = lambda o: o if isinstance(o, tuple) else (o,)
    eager = eager or call
    kernel += checks.tag
    call()  # workspaces and counters outside the capture
    torch.cuda.synchronize()
    before = [t.clone() for t in inputs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = tup(call())
    same = True
    for i in range(2):
        if tweak is not None:
            tweak(i)
        else:
            for t, b in zip(inputs, before):
                t.copy_(torch.roll(b, i + 1, dims=-1) * (1 + 0.5 * i))
        graph.replay()
        ref = tup(eager())
        torch.cuda.synchronize()
        same &= all(torch.equal(o, e) for o, e in zip(outs, ref))
    for t, b in zip(inputs, before):
        t.copy_(b)
    del graph
    checks.extra.setdefault("graph_vs_eager", {})[f"{kernel} {label}"] = same
    print(f"  {kernel:<24s} {label:<40s} CUDA-graph replays against eager calls on new inputs: "
          f"{'the same bits' if same else 'DIFFER'}", flush=True)
    if not same:
        fail(f"{kernel} {label}: a CUDA-graph replay differs from the eager call")


# Kernel B's decode bases at the batched rows of phase 8 (1.5B, bs4: the
# positive streams then the negative ones) and phase 9 (eight 0.5B
# sessions: the positive cache, the negative cache): bases thousands apart,
# 0, 17, mid-cache, S - 1, and an idle row whose length has run past the
# cache (a free slot's positive stream advances every frame).
BATCHED_DECODE = (((12, 2, 128), 4096, False, (0, 17, 2048, 4095, 5096, 1, 9, 33)),
                  ((12, 2, 128), 65536, True, (0, 17, 32768, 65535, 66536, 1, 9, 33)),
                  ((14, 2, 64), STREAM_MAX_LEN, False, (286, 300, 0, 8191, 4000, 17, 290, 9191)),
                  ((14, 2, 64), STREAM_MAX_LEN, False, (31, 7, 1, 40, 8191, 17, 0, 12)))


def check_batched_kernels(checks: Checks, seed: int) -> None:
    """Kernels B, C and D at the rows of the batched serving paths (phases
    8 and 9) against their plain versions, timed with their bounds, each
    also replayed from a CUDA graph against its eager call: C at 8 rows
    (bs4 with CFG), D at 4 rows (the 1.5B at bs4) and 8 (eight 0.5B
    sessions), B's decode route at 8 rows with mixed bases and an idle row
    (BATCHED_DECODE). A's GEMV at 8 rows is check_kernels' (with its graph
    checks)."""
    import torch

    from vibevoice_tpu_torch.ops import flash_attention as fa
    from vibevoice_tpu_torch.ops import head_fused as hf
    from vibevoice_tpu_torch.ops import vocoder_fused as vf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device=dev).to(dt)
    print("batched rows of the serving engines (phases 8 and 9)")

    dim, hid, nl, rows = 1536, 4608, 4, 8
    for quantize in (True, False):
        layers = head_layers(randn, dim, hid, nl)
        packs = rotating(lambda: hf.pack_head_ffns(layers, 1e-5, quantize),
                         3 * nl * dim * hid * (1 if quantize else 2), budget=120 << 20)
        x = randn(rows, dim, dt=torch.float32)
        mods = randn(nl, rows, 3 * dim, dt=torch.float32) * 0.5
        label = f"{nl} layers {'int8' if quantize else 'bf16'} weights rows={rows}"
        call = lambda: hf.fused_head_ffn_stack(packs[0], x, mods)
        out = call()
        ms = bench_ms(lambda pk: hf.fused_head_ffn_stack(pk, x, mods), packs)
        pms = bench_ms(lambda pk: hf.fused_head_ffn_stack_plain(pk, x, mods), packs)
        checks.case("fused_head_ffn_stack", label, out,
                    hf.fused_head_ffn_stack_plain(packs[0], x, mods), 1e-4, ms, pms,
                    bound=bound(2 * rows * 3 * dim * hid * nl,
                                nbytes(*packs[0].arrays.values(), x, mods, out), "f32"))
        fused_call_checks(checks, "fused_head_ffn_stack", label, call,
                          lambda: hf.fused_head_ffn_stack_plain(packs[0], x, mods), (x, mods), 1e-4)
        graph_vs_eager(checks, "fused_head_ffn_stack", label, call, (x, mods))
        del packs

    dim, nb = 2048, 8
    for quantize, rows in ((True, 4), (True, 8), (False, 8)):
        blocks = stage_blocks(randn, dim, nb)
        packs = rotating(lambda: vf.pack_stage(blocks, 1e-5, quantize),
                         nb * 8 * dim * dim * (1 if quantize else 2), budget=120 << 20)
        x, st = randn(rows, 1, dim), randn(nb, rows, 6, dim)
        label = f"{nb} blocks {'int8' if quantize else 'bf16'} weights rows={rows}"
        call = lambda: vf.fused_stage_step(packs[0], x, st)
        (out, ns), (ref, rs) = call(), vf.fused_stage_step_plain(packs[0], x, st)
        ms = bench_ms(lambda pk: vf.fused_stage_step(pk, x, st), packs)
        pms = bench_ms(lambda pk: vf.fused_stage_step_plain(pk, x, st), packs)
        checks.case("fused_stage_step", f"{label}: y", out, ref, 2e-2, ms, pms,
                    bound=bound(2 * rows * nb * (8 * dim * dim + 7 * dim),
                                nbytes(*packs[0].arrays.values(), x, st, out, ns)))
        checks.case("fused_stage_step", f"{label}: new state", ns, rs, 2e-2)
        fused_call_checks(checks, "fused_stage_step", label, call,
                          lambda: vf.fused_stage_step_plain(packs[0], x, st), (x, st), 2e-2)
        graph_vs_eager(checks, "fused_stage_step", label, call, (x, st))
        del packs

    for heads, s_, int8, base in BATCHED_DECODE:
        label = f"{'0.5B ' if heads[2] == 64 else ''}8 rows "
        check_cached_attention(checks, g, heads, 1, s_, int8, base, label=label,
                               graph_bases=None if int8 else (tuple(reversed(base)),))
        nh, kh, d = heads
        q = torch.randn((8, 1, nh, d), generator=g, device=dev).to(torch.bfloat16)
        base_t = torch.tensor(base, dtype=torch.int32, device=dev)
        if int8:
            kc, vc = (torch.randint(-127, 128, (8, kh, s_, d), generator=g, device=dev)
                      .to(torch.int8) for _ in range(2))
            kw = dict(k_scale=torch.rand((8, kh, 1, s_), generator=g, device=dev) / 127,
                      v_scale=torch.rand((8, kh, 1, s_), generator=g, device=dev) / 127)
        else:
            kc, vc = (torch.randn((8, kh, s_, d), generator=g, device=dev).to(torch.bfloat16)
                      for _ in range(2))
            kw = {}
        before = base_t.clone()
        graph_vs_eager(checks, "flash_cached_attention",
                       f"{label}W=1 S={s_} {'int8' if int8 else 'bf16'} bases rolled",
                       lambda: fa.flash_cached_attention(q, kc, vc, base_t, **kw), (q,),
                       tweak=lambda i: (base_t.copy_(torch.roll(before, i + 1)),
                                        q.mul_(1.5)))
        del kc, vc


def check_streaming_attention(checks: Checks, seed: int) -> None:
    """Kernel B at the streaming 0.5B model's shapes: 14 query heads over 2
    KV heads (G 7), head_dim 64, one sample. Decode (W = 1: each speech
    frame's two upper-LM forwards) over a bf16 cache of 8,192 slots at the
    fill of a 36-frame stream and full, also replayed from one CUDA-graph
    capture with other bases; over an int8 cache of 16,384 slots (the
    automatic int8-KV length) at that fill and full; the prefill route at
    W = 5 (a text window) at base 290 and at W = 256 from base 0 (the voice
    preset's prompt), over 8,192 slots. Not a main-path case of the kernels
    line (the 1.5B's are); every case is printed and kept in --out."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    print("kernel B flash_cached_attention at the 0.5B's shapes (14 q heads, 2 KV heads, head_dim "
          "64, B 1; bf16 q; bf16 out: tol 1e-2; library as above)")
    for w, s_, int8, base in ((1, STREAM_MAX_LEN, False, (STREAM_FILL,)),
                              (1, STREAM_MAX_LEN, False, (STREAM_MAX_LEN - 1,)),
                              (1, 16384, True, (STREAM_FILL,)), (1, 16384, True, (16383,)),
                              (5, STREAM_MAX_LEN, False, (STREAM_FILL + 4,)),
                              (STREAM_PRESET, STREAM_MAX_LEN, False, (0,))):
        graph = (w, int8, base) == (1, False, (STREAM_FILL,))
        check_cached_attention(checks, g, (14, 2, 64), w, s_, int8, base, label="0.5B ",
                               graph_bases=((0,), (STREAM_MAX_LEN - 1,), (STREAM_FILL + 7,))
                               if graph else None)


# Device kernels one call of kernel C (4 layers) and D (8 blocks) may run:
# C two streaming launches a layer (gate|up, down), D a prologue and two
# streaming launches a block (fc1, fc2); the split-K GEMV core they ran on
# before took 5 a layer or block (20 and 40).
FUSED_MAX_KERNELS = {"fused_head_ffn_stack": 12, "fused_stage_step": 24}
# Their kernels by the loader or epilogue type in the (mangled) name.
FUSED_PASSES = {"XHeadMod": "gate|up", "XSwiGLU": "down", "stage_prologue": "prologue",
                "EpiBiasGelu": "fc1", "EpiBiasScaleResidual": "fc2"}


# The kernel of torch.cuda._sleep, which the port never runs.
PROFILE_START_KERNEL = "spin_kernel"


def profiler_first_activity() -> None:
    """A short spin and a synchronisation at the start of a profile: the
    first device activity after the profiler starts is now and then not
    recorded (one of D's 24 kernels a call went missing so). The spin's
    kernel (PROFILE_START_KERNEL) is left out of what the profile reads."""
    import torch

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_kernels(fn, attempts: int = 3) -> list:
    """(name, microseconds) of each device activity (kernel, copy, fill) of
    one fn() call after a warm-up, in order, as torch.profiler records them.
    A profile that records no device activity at all (the profiler, used
    many times in one process, now and then returns none) is taken again,
    up to `attempts` times."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiler_first_activity()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and PROFILE_START_KERNEL not in e.name),
                        key=lambda e: e.time_range.start)
        if events:
            break
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def fused_call_checks(checks: Checks, kernel: str, label: str, call, plain, inputs, tol) -> None:
    """Kernel C's or D's call: the device kernels of one call (at most
    FUSED_MAX_KERNELS; their count and mean time by pass are printed and
    kept), a repeat on the same inputs (the same bits), and one
    capture in a CUDA graph replayed three times with new inputs written in
    place, each replay against the plain version (tol as the kernel's)."""
    import torch

    events = device_kernels(call)
    passes = {}
    for name, us in events:
        passes.setdefault(next((v for k, v in FUSED_PASSES.items() if k in name), name[:60]),
                          []).append(us)
    per_pass = {k: (len(v), sum(v) / len(v)) for k, v in passes.items()}
    tagged = kernel + checks.tag
    checks.extra.setdefault("device_kernels_per_call", {})[f"{tagged} {label}"] = dict(
        kernels=len(events), per_pass_count_mean_us=per_pass)
    print(f"  {tagged:<24s} {label:<40s} {len(events)} device kernels a call (profiled: "
          + ", ".join(f"{k} {n} x {us:.2f} us" for k, (n, us) in per_pass.items()) + ")",
          flush=True)
    if not 0 < len(events) <= FUSED_MAX_KERNELS[kernel]:
        fail(f"{kernel} {label}: {len(events)} device kernels a call, not 1 to "
             f"{FUSED_MAX_KERNELS[kernel]}: {sorted(passes)}")
    tup = lambda o: o if isinstance(o, tuple) else (o,)
    first = tup(call())
    if not all(torch.equal(a, b) for a, b in zip(tup(call()), first)):
        fail(f"{kernel} {label}: two calls on the same inputs differ")
    before = [t.clone() for t in inputs]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = tup(call())
    for i in range(3):
        for t, b in zip(inputs, before):
            t.copy_(torch.roll(b, i + 1, dims=-1) * (1 + 0.5 * i))
        graph.replay()
        torch.cuda.synchronize()
        for j, (o, r) in enumerate(zip(outs, tup(plain()))):
            checks.case(kernel, f"{label} CUDA-graph replay {i + 1}" + (f" out {j}" if j else ""),
                        o, r, tol)
    for t, b in zip(inputs, before):
        t.copy_(b)
    del graph


def event_ms(fn, iters: int = 3) -> float:
    """Median CUDA-event time of one fn() call over `iters` calls after one
    warm-up, for calls long enough (milliseconds) that launch overhead is
    noise; autograd calls cannot be captured into a CUDA graph."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# Kernel E's cases at the 1.5B's fine-tuning rows: B*T = 4,096 (B2 T2048)
# at every LM shape, 8,192 (B1 T8192) at gate/up and down; the training
# attention's (B, T, valid lengths), right-padded. The first of each is the
# main-path case.
TRAIN_E_CASES = ((4096, LM_SHAPES), (8192, [s for s in LM_SHAPES if s[0] in ("gate/up", "down")]))
TRAIN_ATTN_CASES = ((2, 2048, (2048, 1500)), (1, 8192, (7000,)))


def check_training_kernels(checks: Checks, seed: int, heads=(12, 2, 128), e_cases=TRAIN_E_CASES,
                           attn_cases=TRAIN_ATTN_CASES, graphs: bool = False,
                           a_f32_tol: float = 1e-5) -> None:
    """Kernel E and the training attention at a fine-tuning path's shapes
    (the 1.5B's by default: 12 query heads over 2 KV heads of 128), and
    kernel A's GEMM on the same f32 rows (tol `a_f32_tol`). With `graphs`,
    E's and the attention's main-path calls are also replayed from a CUDA
    graph against eager calls (the same bits)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vibevoice_tpu_torch.ops import flash_attention as fa
    from vibevoice_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)

    # E: dx of every int8 LM linear of the 1.5B decoder at R = B*T = 4096, f32
    # g (B2 T2048), and of gate/up and down at 8192 (B1 T8192); its two phases
    # (the cast pass forming bf16(g * scale), the GEMM) also timed apart
    if e_cases:
        print("kernel E int8_matmul_t (f32 g, int8 w, f32 scale; f32 out: tol 1e-4 of the peak; "
              "library: torch.mm of bf16 g and a bf16 copy of the weight, transposed; then the "
              "cast pass and the GEMM alone)")
    nh, kh, d = heads
    phases = []
    for rows, shapes in e_cases:
        for name, k, n in shapes:
            ws = rotating(lambda: quant.quantize_weight(randn(k, n) * 0.02), k * n)
            gr = randn(rows, n) * 1e-3
            out = quant.int8_matmul_t(gr, ws[0]["w8"], ws[0]["scale"])
            ref = quant.int8_matmul_t_plain(gr, ws[0]["w8"], ws[0]["scale"])
            ms = bench_ms(lambda w: quant.int8_matmul_t(gr, w["w8"], w["scale"]), ws)
            pms = bench_ms(lambda w: quant.int8_matmul_t_plain(gr, w["w8"], w["scale"]), ws)
            wbs = [(w["w8"].float() * w["scale"]).to(torch.bfloat16) for w in ws]
            gb = gr.to(torch.bfloat16)
            lms = bench_ms(lambda wb: torch.mm(gb, wb.t()), wbs)
            del wbs, gb
            byt = nbytes(gr, ws[0]["w8"], ws[0]["scale"], out)
            flops = 2 * rows * k * n
            main = name == "gate/up" and rows == e_cases[0][0]
            checks.case("int8_matmul_t", f"{name} dx {rows}x{n} -> {k}", out, ref, 1e-4, ms, pms,
                        main=main, bound=bound(flops, byt), library_ms=lms)
            if graphs and main:
                graph_vs_eager(checks, "int8_matmul_t", f"{name} dx {rows}x{n} -> {k}",
                               lambda: quant.int8_matmul_t(gr, ws[0]["w8"], ws[0]["scale"]), (gr,))
            gs = torch.empty(rows, n, dtype=torch.bfloat16, device=dev)
            cast_ms = bench_ms(lambda w: quant._dx_launch(gr, w["w8"], w["scale"], gs, out,
                                                          quant.DX_CAST), ws)
            gemm_ms = bench_ms(lambda w: quant._dx_launch(gr, w["w8"], w["scale"], gs, out,
                                                          quant.DX_GEMM), ws)
            rec = dict(case=f"{name} dx {rows}x{n} -> {k}", ms=ms, cast_ms=cast_ms,
                       cast_bound_ms=bound(0, nbytes(gr, ws[0]["scale"], gs))[0],
                       gemm_ms=gemm_ms,
                       gemm_bound_ms=bound(flops, nbytes(gs, ws[0]["w8"], out))[0],
                       library_ms=lms)
            phases.append(rec)
            print(f"    phases: cast pass {cast_ms:.4f} ms (bound {rec['cast_bound_ms']:.4f}, "
                  f"bytes), GEMM {gemm_ms:.4f} ms (bound {rec['gemm_bound_ms']:.4f}); together "
                  f"{ms:.4f} ms = {ms / lms:.2f}x torch.mm", flush=True)
            del gs
            if rows == e_cases[0][0]:  # kernel A at the same training rows (f32 x): its GEMM route
                check_int8_matmul(checks, f"{name} {k}x{n} rows={rows} f32 (training)",
                                  randn(rows, k), ws, a_f32_tol, iters=5)
            del ws
    checks.extra["int8_matmul_t_phases" + checks.tag] = phases

    # training attention: `heads` (query heads, KV heads, D), f32, right padded
    print(f"training attention ({nh} query heads over {kh} KV heads of {d}; f32, the tensor-core "
          "route: three-term bf16 split; right-padded "
          "batch compared on valid rows and with dO zero on pad rows: O tol 1e-4, dQ/dK/dV tol "
          "1e-3 of the peak; library: SDPA f32 with the segment-causal mask on K/V repeated to the "
          "query heads, held to its fused memory-efficient kernel: its forward, and autograd "
          "through it for the backward)")
    records = []
    for b, t, lens in attn_cases:
        q, k, v = randn(b, t, nh, d), randn(b, t, kh, d), randn(b, t, kh, d)
        valid = torch.zeros(b, t, dtype=torch.bool, device=dev)
        for i, n in enumerate(lens):
            valid[i, :n] = True
        do = randn(b, t, nh, d) * valid[:, :, None, None]
        label = f"B={b} T={t} valid={list(lens)}"

        def grads(fn):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*leaves, valid)
            return (out.detach(), *torch.autograd.grad(out, leaves, do))

        kern = grads(fa.flash_train_attention)
        plain = grads(fa.train_attention_plain)
        rows_ok = valid[:, :, None, None]
        kr, vr = k.repeat_interleave(nh // kh, dim=2), v.repeat_interleave(nh // kh, dim=2)
        seg = valid.to(torch.int32)
        if fa._train_plan(q.dtype, d) != "wgmma":
            fail(f"training attention {label}: not on the tensor-core route")
        o, lse = fa.flash_train_attention_fwd(q, kr, vr, seg, d ** -0.5)
        fwd_ms = event_ms(lambda: fa.flash_train_attention_fwd(q, kr, vr, seg, d ** -0.5))
        fwd_pms = event_ms(lambda: fa.train_attention_plain(q, k, v, valid))
        bwd_ms = event_ms(lambda: fa.flash_train_attention_bwd(q, kr, vr, seg, o, lse, do,
                                                               d ** -0.5))
        split_ms = event_ms(lambda: fa._train_operands(q, kr, vr))  # the split pass of q, k, v
        ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
        out_p = fa.train_attention_plain(ql, kl, vl, valid)
        bwd_pms = event_ms(lambda: torch.autograd.grad(out_p, (ql, kl, vl), do, retain_graph=True))
        del out_p, ql, kl, vl
        # the library: SDPA, f32, causal within each segment (valid, pad), on
        # K/V repeated to the query heads as the port's wrapper repeats them,
        # held to PyTorch's fused memory-efficient kernel (enable_gqa with a
        # mask would take the unfused math fallback); its forward, and
        # autograd through it (forward excluded) for the backward
        pos = torch.arange(t, device=dev)
        mask = ((pos[:, None] >= pos[None, :])[None]
                & (valid[:, :, None] == valid[:, None, :]))[:, None]  # (B, 1, T, T)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, kr, vr))
        dot = do.transpose(1, 2)
        lib_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_ms = event_ms(lib_fwd)
            out_l = lib_fwd()
            lib_bwd = lambda: torch.autograd.grad(out_l, (qt, kt, vt), dot, retain_graph=True)
            lib_bwd_ms = event_ms(lib_bwd)
            lib_kernels = []
            for fn in (lib_fwd, lib_bwd):
                # device_kernels profiles again where the profiler, used many
                # times in one process, recorded no device activity
                by_name: dict = {}
                for nm, us in device_kernels(fn):
                    by_name[nm] = by_name.get(nm, 0.0) + us
                top = max(by_name, key=by_name.get) if by_name else "no device activity recorded"
                lib_kernels.append(top[:80])
                if "fmha" not in top.lower() and "attention" not in top.lower():
                    fail(f"training attention {label}: SDPA's top kernel is not a fused "
                         f"attention kernel: {top[:120]}")
        del mask, qt, kt, vt, out_l, dot
        # The bound: the function's operations (QK^T and PV over each
        # segment's causal pairs; the backward recomputes P and forms dV, dP,
        # dQ and dK: five products) at the bf16 tensor-core peak, the units
        # these kernels run on, or its bytes if more. Beside it, for reference
        # only: the same operations at the f32 CUDA-core peak, and the work
        # this design issues (three bf16 terms a product, two products in the
        # forward and seven in the backward, S and dP in both backward
        # kernels, plus the split pass moving each f32 operand in once and out
        # as hi and lo)
        pairs = sum(m * (m + 1) // 2 for n in lens for m in (n, t - n))
        fwd_flops = 4 * d * nh * pairs
        fwd_bytes = nbytes(q, kr, vr, seg, o, lse)
        bwd_bytes = nbytes(q, kr, vr, seg, o, lse, do) + 3 * nbytes(q)
        fwd_bound, bwd_bound = bound(fwd_flops, fwd_bytes), bound(2.5 * fwd_flops, bwd_bytes)
        fwd_f32 = bound(fwd_flops, fwd_bytes, "f32")[0]
        bwd_f32 = bound(2.5 * fwd_flops, bwd_bytes, "f32")[0]
        fwd_design = (3 * fwd_flops / PEAK_FLOPS["bf16"] * 1e3
                      + 2 * nbytes(q, kr, vr) / HBM_BYTES_PER_S * 1e3)
        bwd_design = (3 * 3.5 * fwd_flops / PEAK_FLOPS["bf16"] * 1e3
                      + 2 * nbytes(q, kr, vr, do) / HBM_BYTES_PER_S * 1e3)
        main = (b, t, lens) == attn_cases[0]
        checks.case("flash_train_attention_fwd", f"{label}: O (valid rows)", kern[0] * rows_ok,
                    plain[0] * rows_ok, 1e-4, fwd_ms, fwd_pms, main=main, library_ms=lib_ms,
                    bound=fwd_bound)
        errs = {"O": rel_err(kern[0] * rows_ok, plain[0] * rows_ok)[1]}
        for i, nm in ((1, "dQ"), (2, "dK"), (3, "dV")):
            timing = dict(ms=bwd_ms, plain_ms=bwd_pms, main=main, bound=bwd_bound,
                          library_ms=lib_bwd_ms) if i == 1 else {}
            checks.case("flash_train_attention_bwd", f"{label}: {nm}", kern[i], plain[i], 1e-3,
                        **timing)
            errs[nm] = rel_err(kern[i], plain[i])[1]
        rec = dict(case=label, fwd_ms=fwd_ms, fwd_bound_ms=fwd_bound[0], fwd_f32_bound_ms=fwd_f32,
                   fwd_design_ms=fwd_design, bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound[0],
                   bwd_f32_bound_ms=bwd_f32, bwd_design_ms=bwd_design, split_qkv_ms=split_ms,
                   split_qkv_bound_ms=2 * nbytes(q, kr, vr) / HBM_BYTES_PER_S * 1e3,
                   sdpa_fwd_ms=lib_ms, sdpa_bwd_ms=lib_bwd_ms, sdpa_kernels=lib_kernels,
                   plain_fwd_ms=fwd_pms, plain_bwd_ms=bwd_pms, rel_err=errs)
        records.append(rec)
        print(f"    bounds (tensor cores): forward {fwd_bound[0]:.4f} ms (the kernel at "
              f"{fwd_bound[0] / fwd_ms:.1%} of it), backward {bwd_bound[0]:.4f} ms (at "
              f"{bwd_bound[0] / bwd_ms:.1%}); beside them "
              f"the f32 CUDA-core bounds {fwd_f32:.4f} / {bwd_f32:.4f} ms and the design's issued "
              f"work {fwd_design:.4f} / {bwd_design:.4f} ms; split pass of q, k, v {split_ms:.4f} "
              f"ms (bound {rec['split_qkv_bound_ms']:.4f}, bytes); SDPA forward / backward "
              f"{lib_ms:.4f} / {lib_bwd_ms:.4f} ms ({'; '.join(lib_kernels)})", flush=True)
        if graphs and main:
            graph_vs_eager(checks, "flash_train_attention_fwd", label,
                           lambda: fa.flash_train_attention_fwd(q, kr, vr, seg, d ** -0.5), (q,))
            graph_vs_eager(checks, "flash_train_attention_bwd", label,
                           lambda: fa.flash_train_attention_bwd(q, kr, vr, seg, o, lse, do,
                                                                d ** -0.5), (q, do))
        del kern, plain, o, lse
        torch.cuda.empty_cache()
    checks.extra["train_attention" + checks.tag] = records


def check_ring_kernel(checks: Checks, seed: int, heads=(12, 2, 128), k_lens=(16384, 12000),
                      lm_shapes=LM_SHAPES, four_ring: bool = True, graphs: bool = False) -> None:
    """Kernel F at a model's widths (the 1.5B's by default: 12 query heads
    over 2 KV heads, D 128), bf16 q/K/V, f32 state, one sample per entry of
    `k_lens` (the 1.5B's second ends mid-shard): with `four_ring` the hops
    of rank 2 of a 4-way ring over a 16,384-token prompt, then the one hop
    of a world of one over the longest prompt; then kernel A at the rows
    that world-of-one ring prefill gives it (`lm_shapes`). With `graphs`,
    F's hop and A's gate/up call are also replayed from a CUDA graph
    against eager calls (the same bits)."""
    import torch

    from vibevoice_tpu_torch.ops import flash_attention as fa
    from vibevoice_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    randn = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    b, (nh, kh, d) = len(k_lens), heads
    tol = 1e-4
    print(f"kernel F flash_ring_block (bf16 q/K/V, f32 state; state after each hop and the "
          f"normalised output: tol {tol:g} of the peak; a wholly-future block must leave the "
          f"state bit-identical)")

    def hop(label, state_k, state_p, q, kb, vb, main=False, **kw):
        """One hop through the kernel and the plain fold. The bound counts
        the causal pairs of this block's live keys and the state read and
        written; no single PyTorch call updates an online-softmax state."""
        q_pos = kw["q_start"] + torch.arange(q.shape[1], device=dev)
        k_pos = kw["k_start"] + torch.arange(kb.shape[2], device=dev)
        live = (k_pos[None, None] <= q_pos[None, :, None]) & (
            k_pos[None, None] < kw["k_len"][:, None, None])
        flops = 4 * d * nh * int(live.sum())
        del live
        # a block wholly in the future needs only k_len read: the state stays
        byt = nbytes(kw["k_len"]) + (nbytes(q, kb, vb) + 2 * nbytes(*state_k) if flops else 0)
        before = [x.clone() for x in state_k]
        fa.flash_ring_block(state_k, q, kb, vb, **kw)
        fa.flash_ring_block_plain(state_p, q, kb, vb, **kw)
        scratch_k, scratch_p = [x.clone() for x in before], [x.clone() for x in before]
        ms = event_ms(lambda: fa.flash_ring_block(scratch_k, q, kb, vb, **kw))
        pms = event_ms(lambda: fa.flash_ring_block_plain(scratch_p, q, kb, vb, **kw))
        del scratch_k, scratch_p
        for name, got, want in zip(("m", "l"), state_k, state_p):
            checks.case("flash_ring_block", f"{label}: {name}", got, want, tol)
        checks.case("flash_ring_block", f"{label}: acc", state_k[2], state_p[2], tol, ms, pms,
                    main=main, bound=bound(flops, byt))
        return before

    if four_ring:
        # rank 2 of a 4-way ring over a 16,384-token prompt: its own block, then
        # ranks 1, 0 and 3's; the last lies wholly in the future
        n, rank, tl = 4, 2, 4096
        k_len = torch.tensor([n * tl, 10000], dtype=torch.int32, device=dev)
        q = randn(b, tl, nh, d)
        blocks = [(randn(b, kh, tl, d), randn(b, kh, tl, d)) for _ in range(n)]
        state_k = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
        state_p = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
        for h in range(n):
            src = (rank - h) % n
            before = hop(f"4-ring rank {rank} Tl={tl} hop {h} k_start={src * tl}", state_k,
                         state_p, q, *blocks[src], q_start=rank * tl, k_start=src * tl,
                         k_len=k_len)
        if not all(torch.equal(x, y) for x, y in zip(state_k, before)):
            fail("flash_ring_block: the wholly-future block changed the state")
        checks.case("flash_ring_block", f"4-ring rank {rank} Tl={tl}: output",
                    fa.ring_state_out(state_k, tl, torch.float32),
                    fa.ring_state_out(state_p, tl, torch.float32), tol)
        del blocks, state_k, state_p

    # a world of one: one hop over the whole prompt (the main path)
    tl = max(k_lens)
    k_len = torch.tensor(k_lens, dtype=torch.int32, device=dev)
    q, kb, vb = randn(b, tl, nh, d), randn(b, kh, tl, d), randn(b, kh, tl, d)
    state_k = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
    state_p = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
    label = f"world of one Tl={tl} k_len={k_len.tolist()}"
    hop(label, state_k, state_p, q, kb, vb, main=True, q_start=0, k_start=0, k_len=k_len)
    checks.case("flash_ring_block", f"world of one Tl={tl}: output",
                fa.ring_state_out(state_k, tl, torch.float32),
                fa.ring_state_out(state_p, tl, torch.float32), tol)
    if graphs:  # the hop from a fresh state, into a graph's scratch and an eager one's
        del state_p
        init = fa.ring_state_init(b, kh, tl * nh // kh, d, device=dev)
        scratch = [[x.clone() for x in init] for _ in range(2)]

        def ring_hop(st):
            for x, x0 in zip(st, init):
                x.copy_(x0)
            return tuple(fa.flash_ring_block(st, q, kb, vb, q_start=0, k_start=0, k_len=k_len))

        graph_vs_eager(checks, "flash_ring_block", label, lambda: ring_hop(scratch[0]), (q,),
                       eager=lambda: ring_hop(scratch[1]))
        del scratch, init
    del q, kb, vb, state_k

    # A on every LM linear of the world-of-one ring prefill: B * Tl rows
    rows = b * tl
    print(f"kernel A int8_matmul at the ring prefill's {rows} rows (bf16 x, int8 w, f32 scale; "
          f"bf16 out: tol 1e-2 of the peak; library: torch.mm on a bf16 copy of the weight)")
    for name, k, n in lm_shapes:
        w = quant.quantize_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
        x = randn(rows, k)
        check_int8_matmul(checks, f"{name} {k}x{n} rows={rows} (ring prefill)", x,
                          [w], 1e-2, main=name == "gate/up",
                          timer=lambda fn, ops: event_ms(lambda: fn(ops[0])))
        if graphs and name == "gate/up":
            graph_vs_eager(checks, "int8_matmul_gemm", f"{name} {k}x{n} rows={rows}",
                           lambda: quant.int8_matmul(x, w["w8"], w["scale"]), (x,))
        del w, x


def tiny_card_vs_cpu(seed: int) -> None:
    """generate() on the tiny config: kernels on the card against the plain
    versions on the CPU, f32, same weights and injected noise."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    hop = cfg.acoustic_tokenizer_config.hop_length
    toks = inf.SpecialTokens(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
    rng = np.random.RandomState(seed)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6], ids[0, -1] = 7, 5
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    kw = dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * hop).astype(np.float32),
              speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask, tokens=toks,
              noise_bank={"init": rng.randn(16, 1, cfg.acoustic_vae_dim).astype(np.float32),
                          "vae_std": rng.randn(1).astype(np.float32),
                          "vae_eps": rng.randn(1, 4, cfg.acoustic_vae_dim).astype(np.float32)},
              forced_tokens=np.array([7, 7, 7, 6, 5, 7, 7, 7, 2])[:, None],
              opts=inf.GenerateOptions(ddpm_steps=4, max_length=64, kv_int8=True))
    outs = []
    for dev in ("cuda", "cpu"):
        p = init(cfg, seed=seed, device="cpu")
        for part in (p["acoustic_tokenizer"]["decoder"], p["semantic_tokenizer"]["encoder"]):
            for blk in (b for stage in part["stages"] for b in stage):  # make the blocks work
                blk["gamma"].fill_(0.3)
                blk["ffn_gamma"].fill_(0.3)
        p = vv.fuse_for_serving(vv.quantize_for_inference(p), cfg, quantize=True)
        outs.append(inf.generate(cfg, _to(p, dev), **kw))
    a, b = outs[0].speech_outputs[0], outs[1].speech_outputs[0]
    if not np.array_equal(outs[0].sequences, outs[1].sequences):
        fail("tiny generate: card and CPU token sequences differ")
    err = float(np.abs(a - b).max())
    peak = float(np.abs(b).max())
    print(f"  tiny generate card vs CPU: {len(a)} samples, max_abs_err {err:.3e} of peak "
          f"{peak:.3e} (tol 1e-3 of the peak)", flush=True)
    if not (peak > 0 and err <= 1e-3 * peak):
        fail("tiny generate: the card's waveform disagrees with the CPU's")


def _to(tree, dev):
    import torch

    from vibevoice_tpu_torch.ops.vocoder_fused import PackedStage

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, PackedStage):
        return PackedStage({k: v.to(dev) for k, v in tree.arrays.items()}, tree.eps, tree.dim,
                           tree.hidden, tree.n_blocks, tree.quantized)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def serving_model(seed: int, config: Path = CONFIG_1P5B) -> dict:
    """The full-width serving set-up (the 1.5B's by default) shared by the
    serving and the sequence-parallel prefill phases (tts.VibeVoiceTTS.random:
    random bf16 weights from the seed, int8 LM + lm_head, the fused serving
    packs, the hash-bucket tokenizer with the Qwen special ids), the two
    voices and the two-speaker script."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.tts import VibeVoiceTTS

    t0 = time.perf_counter()
    tts = VibeVoiceTTS.random(str(config), seed=seed)
    torch.cuda.synchronize()
    print(f"  {config.name} params (bf16, int8 LM + lm_head, fused serving packs) built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    cfg = tts.cfg
    sr = 24_000
    t = np.arange(int(VOICE_SECONDS * sr)) / sr
    rng = np.random.RandomState(seed)
    voices = [(0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.randn(t.size)).astype(np.float32)
              for f in (180.0, 260.0)]
    script = ("Speaker 1: Welcome back to the show, today we talk about speech synthesis.\n"
              "Speaker 2: Thanks for having me, it is a pleasure to be here.")
    return dict(cfg=cfg, params=tts.params, processor=tts.processor, toks=tts.tokens,
                voices=voices, script=script, hop=cfg.acoustic_tokenizer_config.hop_length, sr=sr)


# Graphed against eager serving (the same forced run, the same kernels): the
# audio's max |diff| over its peak. A replay launches the eager frame's
# kernels on the same inputs: on an H100 with --seed 0 the two give the same
# bits (0.0 at both lengths and both K). The limit, a tenth of one bf16
# rounding of the peak, leaves room for a library routine that picks another
# algorithm under capture.
GRAPH_TOL = 1e-3
FRAMES_PER_DISPATCH = (1, 4)


def forced_scripts(toks, frames: int) -> tuple:
    """The forced token script of `frames` frames (frames - 3 speech frames,
    one speech_end -> speech_start in the middle, eos) and the short
    3-frame one, as lists of ids."""
    half = (frames - 3) // 2
    forced = ([toks.speech_diffusion] * half + [toks.speech_end, toks.speech_start]
              + [toks.speech_diffusion] * (frames - 3 - half) + [toks.eos])
    return forced, [toks.speech_diffusion] * 2 + [toks.eos]


def end_to_end(model: dict, seed: int, frames: int, lengths=(4096, None),
               ks=FRAMES_PER_DISPATCH) -> dict:
    """The serving path at max_length 4096 (bf16 KV) and the model's own
    (None: 65,536 for the 1.5B, int8 KV), or `lengths`:
    for K in `ks`, the default generate(), which replays the
    captured graph of make_step_fn / make_multi_step_fn, and the same runs
    through that step function's eager call. Each is a short (3-frame) and
    a forced (`frames`-frame) run; per-frame ms comes from their difference.
    Graphed and eager must give identical tokens, audio within GRAPH_TOL of
    the peak and equal, non-zero launch counts of every serving kernel, and
    the graphed run must replay a graph. The graphed forced run at 4096
    and K = 4 (its tokens and audio) is returned as ``reference``, which
    phase 11 repeats on the weights loaded from a checkpoint."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    cfg, params, toks, hop, sr = (model[k] for k in ("cfg", "params", "toks", "hop", "sr"))
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    forced, short = forced_scripts(toks, frames)
    n_diff = frames - 3
    print(f"  prompt {proc.input_ids.shape[1]} tokens, voice prompts "
          f"{proc.speech_tensors.shape} ({proc.speech_masks.sum()} latent frames); forced script "
          f"{len(forced)} frames ({n_diff} speech frames, one speech_end -> speech_start)",
          flush=True)

    # the prompt's prefill (105 tokens) takes A's GEMM and B's prefill route
    names = ("int8_matmul", "int8_matmul_gemm", "flash_cached_attention",
             "flash_cached_attention_prefill", "fused_head_ffn_stack", "fused_stage_step")

    def run(opts, script_tokens, step_fn):
        kw = dict(input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                  speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                  speech_input_mask=proc.speech_input_mask, tokens=toks, seed=seed,
                  forced_tokens=np.asarray(script_tokens, np.int64)[:, None])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inf.generate(cfg, params, opts=opts, step_fn=step_fn, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs, reference = {}, None
    total_launches = dict.fromkeys(names, 0)
    for max_length in lengths:
        length = max_length or cfg.decoder_config.max_position_embeddings
        kv_int8 = inf.resolve_kv_int8(inf.GenerateOptions(max_length=max_length), length).kv_int8
        for k in ks:
            opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=max_length,
                                       frames_per_dispatch=k)
            fn = (inf.make_multi_step_fn(cfg, toks, opts, k, inject=True) if k > 1
                  else inf.make_step_fn(cfg, toks, opts, inject=True))
            base = None
            for mode, step_fn in (("graphed", None), ("eager", fn.eager)):
                label = f"max_length={length} K={k} {mode}"
                capture_wall = None
                if mode == "graphed":  # warm-up: the first run captures the graph
                    capture_wall = run(opts, short, None)[1]
                replays = fn.replays
                retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
                reset_counts(names)
                out, wall = run(opts, forced, step_fn)
                counts = read_counts(names)
                replays = fn.replays - replays
                # the caching allocator's retries (cudaFree of its cache, then cudaMalloc)
                retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
                short_out, short_wall = run(opts, short, step_fn)
                audio = out.speech_outputs[0]
                if audio is None or audio.size == 0:
                    fail(f"{label}: no audio")
                if not np.isfinite(audio).all():
                    fail(f"{label}: non-finite audio")
                if not np.abs(audio).max() > 0:
                    fail(f"{label}: all-zero audio")
                if audio.size != n_diff * hop:
                    fail(f"{label}: {audio.size} samples for {n_diff} speech frames")
                if not np.array_equal(out.sequences[0, proc.input_ids.shape[1]:],
                                      np.asarray(forced)):
                    fail(f"{label}: the token sequence does not follow the forced script")
                missing = [n for n, v in counts.items() if v == 0]
                if missing:
                    fail(f"{label}: kernels never launched on the main path: {missing}")
                if (mode == "graphed") != (replays > 0):
                    fail(f"{label}: {replays} graph replays")
                per_frame = (wall - short_wall) / (len(forced) - len(short))
                # kernel B's decode bases at the last frame: the positive
                # stream's tokens, and the negative stream's since its last
                # speech_start
                restart = len(forced) - forced[::-1].index(toks.speech_start)
                fill = (out.sequences.shape[1], 1 + forced[restart:].count(toks.speech_diffusion))
                rec = dict(kv_int8=kv_int8, frames_per_dispatch=k, mode=mode,
                           frames=len(forced), speech_frames=n_diff, audio_seconds=audio.size / sr,
                           wall_s=wall, short_wall_s=short_wall, per_frame_ms=per_frame * 1e3,
                           rtf=(audio.size / sr) / wall, launches=counts, replays=replays,
                           capturing_short_wall_s=capture_wall, alloc_retries=retries,
                           decode_fill=fill, peak_abs=float(np.abs(audio).max()))
                if base is None:
                    base = (out, counts)
                    for n, v in counts.items():
                        total_launches[n] += v
                    if max_length == 4096 and k == 4:  # outputs are static buffers: copy
                        reference = (np.array(out.sequences), np.array(audio))
                else:  # eager against the graphed run before it
                    ref = base[0].speech_outputs[0]
                    err = float(np.abs(audio - ref).max() / np.abs(ref).max())
                    rec["graphed_vs_eager_rel_err"] = err
                    print(f"  {label}: against the graphed run, tokens "
                          f"{'equal' if np.array_equal(out.sequences, base[0].sequences) else 'DIFFER'}, "
                          f"audio max |diff| {err:.3e} of the peak (tol {GRAPH_TOL:g}), launches "
                          f"{'equal' if counts == base[1] else 'DIFFER'}", flush=True)
                    if not np.array_equal(out.sequences, base[0].sequences):
                        fail(f"{label}: tokens differ from the graphed run")
                    if not err <= GRAPH_TOL:
                        fail(f"{label}: audio differs from the graphed run by {err:.3e} of the peak")
                    if counts != base[1]:
                        fail(f"{label}: launches {counts} against the graphed run's {base[1]}")
                runs[label] = rec
                print(f"  generate {label} (kv_int8={kv_int8}): {len(forced)} frames, "
                      f"{audio.size / sr:.2f} s audio, wall {wall:.3f} s (prefill included), "
                      f"{per_frame * 1e3:.2f} ms per frame (from {len(short)}- and "
                      f"{len(forced)}-frame runs), RTF {rec['rtf']:.3f}, {replays} replays, "
                      + ("" if capture_wall is None else
                         f"the capturing {len(short)}-frame run {capture_wall:.3f} s against "
                         f"{short_wall:.3f} s replayed, ")
                      + f"{retries} allocator retries, "
                      f"decode fill at the last frame {fill} (SERVING_FILL {SERVING_FILL}), "
                      f"launches {counts}", flush=True)
    return dict(runs=runs, launches=total_launches, reference=reference)


def unforced_end_to_end(model: dict, seed: int, k: int = 4, windows: int = 3,
                        batch: int = 4, tries: int = 8) -> dict:
    """The default generate() with nothing injected, at max_length 4096:
    do_sample with top_p 0.9 and the SDE solver, so that before every
    window the host draws the initial latents, the SDE noise and the token
    choice's uniforms from the seeded generator into the graph's static
    buffers, and the token choice samples by inverse CDF. A batch of
    `batch` copies of the script (each sample draws its own tokens), for
    `windows` windows of K frames, after one run that captures: graphed
    against the same run through the step function's eager call, identical
    tokens, audio within GRAPH_TOL of the peak and equal launch counts. The
    random model may sample eos before any speech frame; the first of
    `tries` seeds from --seed whose graphed run has a speech frame is the
    one compared (it fails if none has). Then one window of the step
    function itself from one prefilled carry on one set of draws, graphed
    against eager: identical tokens and every frame's audio (diffusing or
    not) within GRAPH_TOL."""
    import itertools

    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    cfg, params, toks, hop = (model[k_] for k_ in ("cfg", "params", "toks", "hop"))
    proc = model["processor"](text=[model["script"]] * batch,
                              voice_samples=[model["voices"]] * batch)
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096, do_sample=True,
                               top_p=0.9, sde=True, frames_per_dispatch=k)
    fn = inf.make_multi_step_fn(cfg, toks, opts, k)
    names = ("int8_matmul", "flash_cached_attention", "fused_head_ffn_stack", "fused_stage_step")

    def run(s, step_fn, n_windows=windows):
        calls = itertools.count()
        replays = fn.replays
        reset_counts(names)
        out = inf.generate(cfg, params, input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                           speech_tensors=proc.speech_tensors,
                           speech_frame_valid=proc.speech_masks,
                           speech_input_mask=proc.speech_input_mask, tokens=toks, seed=s,
                           opts=opts, step_fn=step_fn,
                           stop_check_fn=lambda: next(calls) >= n_windows)
        return out, read_counts(names), fn.replays - replays

    speech = lambda out: sum(0 if a is None else a.size // hop for a in out.speech_outputs)
    run(seed, None, 1)  # captures
    for used in range(seed, seed + tries):
        graphed, g_counts, g_replays = run(used, None)
        if speech(graphed):
            break
    else:
        fail(f"unforced run: no speech frame in {tries} seeds from {seed}")
    eager, e_counts, _ = run(used, fn.eager)
    new = graphed.sequences[:, proc.input_ids.shape[1]:]
    err = 0.0
    for i, (a_g, a_e) in enumerate(zip(graphed.speech_outputs, eager.speech_outputs)):
        if (a_g is None) != (a_e is None):
            fail(f"unforced run: sample {i} has audio from one of graphed and eager only")
        if a_g is not None:
            if a_g.shape != a_e.shape or not np.isfinite(a_g).all():
                fail(f"unforced run: sample {i}'s audio {a_g.shape} against eager {a_e.shape}, "
                     "or not finite")
            err = max(err, float(np.abs(a_g - a_e).max() / max(np.abs(a_e).max(), 1e-30)))
    print(f"  unforced generate() max_length=4096 K={k} B={batch} (do_sample, top_p 0.9, sde), "
          f"{windows} windows, seed {used}: {new.shape[1]} frames, tokens {new.tolist()}, "
          f"{speech(graphed)} speech frames; graphed {g_replays} replays; against eager tokens "
          f"{'equal' if np.array_equal(graphed.sequences, eager.sequences) else 'DIFFER'}, audio "
          f"max |diff| {err:.3e} of the peak (tol {GRAPH_TOL:g}), launches "
          f"{'equal' if g_counts == e_counts else 'DIFFER'} {g_counts}", flush=True)
    if g_replays == 0:
        fail("unforced run: the default generate() replayed no graph")
    if not np.array_equal(graphed.sequences, eager.sequences):
        fail("unforced run: graphed and eager tokens differ")
    if not err <= GRAPH_TOL:
        fail(f"unforced run: audio differs from eager by {err:.3e} of the peak")
    if g_counts != e_counts:
        fail(f"unforced run: launches {g_counts} against eager {e_counts}")

    # one window from one prefilled carry: every frame's audio, on one set of draws
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = proc.input_ids.shape[0]
    speech_args = (torch.as_tensor(proc.speech_tensors, device=dev, dtype=torch.float32),
                   torch.as_tensor(proc.speech_masks, device=dev),
                   torch.as_tensor(proc.speech_input_mask, device=dev), g, None)
    carry = inf.prefill_fn(cfg, params, torch.as_tensor(proc.input_ids, device=dev), 4096,
                           torch.as_tensor(proc.attention_mask, device=dev), speech_args, toks)
    noise = inf.draw_noise(cfg, opts, b, g, frames=k)
    if any(t is None for t in noise):
        fail(f"unforced window: a draw is missing: {[t is None for t in noise]}")
    ext = torch.zeros(k, b, dtype=torch.bool, device=dev)
    clone = lambda c: inf._tree_map(lambda t: t.clone(), c)
    carry_e, out_e = fn.eager(params, clone(carry), noise, ext)
    carry_g, out_g = fn(params, clone(carry), noise, ext)
    torch.cuda.synchronize()
    rel = lambda a, r: float((a.float() - r.float()).abs().max() / r.float().abs().max())
    win_err, h_err = rel(out_g.audio, out_e.audio), rel(carry_g.h_pos, carry_e.h_pos)
    same_tokens = torch.equal(out_g.tokens, out_e.tokens)
    print(f"  unforced window of {k} frames from one carry: tokens {out_g.tokens.tolist()} "
          f"({'equal' if same_tokens else 'DIFFER'} eager's), every frame's audio max |diff| "
          f"{win_err:.3e} of the peak, h_pos {h_err:.3e} (tol {GRAPH_TOL:g})", flush=True)
    if not (same_tokens and torch.equal(out_g.finished, out_e.finished)):
        fail("unforced window: graphed and eager tokens differ")
    if not (torch.isfinite(out_g.audio.float()).all() and win_err <= GRAPH_TOL
            and h_err <= GRAPH_TOL):
        fail(f"unforced window: audio {win_err:.3e} or h_pos {h_err:.3e} of the peak from eager")
    return dict(seed=used, frames=int(new.shape[1]), tokens=new.tolist(),
                speech_frames=speech(graphed), replays=g_replays,
                graphed_vs_eager_rel_err=err, launches=g_counts,
                window_audio_rel_err=win_err, window_h_pos_rel_err=h_err)


# The port's kernels of the frame by a part of their (demangled) device
# names. A's GEMV, C's and D's passes are all the streaming core
# (stream_gemv_kernel), told apart by the loader or epilogue type in the
# name; D's blocks also run a prologue.
PORT_DEVICE_KERNELS = (("flash_decode", "flash_cached_attention"),
                       ("flash_prefill", "flash_cached_attention_prefill"),
                       ("int8_gemm_kernel", "int8_matmul_gemm"),
                       ("cast_bf16_kernel", "int8_matmul_gemm"),
                       ("stage_prologue", "fused_stage_step"),
                       ("EpiBiasGelu", "fused_stage_step"),
                       ("EpiBiasScaleResidual", "fused_stage_step"),
                       ("XHeadMod", "fused_head_ffn_stack"),
                       ("XSwiGLU", "fused_head_ffn_stack"),
                       ("stream_gemv_kernel", "int8_matmul"))


def port_kernel_counts(names) -> dict:
    """Device activities of the port's kernels by wrapper (PORT_DEVICE_KERNELS)."""
    counts: dict = {}
    for name in names:
        wrapper = next((w for part, w in PORT_DEVICE_KERNELS if part in name), None)
        if wrapper is not None:
            counts[wrapper] = counts.get(wrapper, 0) + 1
    return counts


def profiled_acts(fn, cpu: bool = False, attempts: int = 3):
    """(start us, end us, name) of each device activity of one fn() call
    under torch.profiler, in order, and the host's wall in ms from the call
    to the end of its device work. A profile that records no device
    activity (now and then) is taken again, up to `attempts` times."""
    import torch
    from torch.autograd import DeviceType

    kinds = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        kinds.append(torch.profiler.ProfilerActivity.CPU)
    for _ in range(attempts):
        with torch.profiler.profile(activities=kinds) as prof:
            profiler_first_activity()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        acts = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and PROFILE_START_KERNEL not in e.name), key=lambda a: a[0])
        if acts:
            break
    return acts, wall_ms


def graphed_profile(model: dict, seed: int, frames: int = 17) -> dict:
    """torch.profiler over one replay of a captured window of `frames`
    forced speech frames (make_multi_step_fn) at max_length 4096, after a
    warm-up replay: the device's busy share of the window (the union of its
    kernels, copies and fills) against the host's wall from the replay to
    the end of its work, the top kernels by device time and the idle gaps
    between device activities. The replay's device kernels of each port
    kernel (PORT_DEVICE_KERNELS) must equal those of the same window run
    eagerly, whose wrapper calls, counted by the wrappers, must equal the
    launches the capture recorded for each: so a replay that skips or
    breaks a kernel fails here."""
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    cfg, params, toks = model["cfg"], model["params"], model["toks"]
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = proc.input_ids.shape[0]
    speech_args = (torch.as_tensor(proc.speech_tensors, device=dev, dtype=torch.float32),
                   torch.as_tensor(proc.speech_masks, device=dev),
                   torch.as_tensor(proc.speech_input_mask, device=dev), g, None)
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096)
    carry = inf.prefill_fn(cfg, params, torch.as_tensor(proc.input_ids, device=dev), 4096,
                           torch.as_tensor(proc.attention_mask, device=dev), speech_args, toks)
    fn = inf.make_multi_step_fn(cfg, toks, opts, frames, inject=True)
    hooks = {"init": torch.randn(1, b, cfg.acoustic_vae_dim, generator=g, device=dev),
             "forced": torch.full((frames, b), toks.speech_diffusion, device=dev)}
    noise = inf.draw_noise(cfg, opts, b, g, frames=frames, inject=True)
    ext = torch.zeros(frames, b, dtype=torch.bool, device=dev)
    eager_carry = inf._tree_map(lambda t: t.clone(), carry)
    carry, _ = fn(params, carry, noise, ext, hooks)  # capture and a first replay
    cap = next(c for key, c in inf._captures.items() if key[0] is fn and c.params is params)
    torch.cuda.synchronize()
    replay_ms, call_ms = [], []
    for _ in range(3):  # the window's device time by CUDA events, without the profiler
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        carry, out = fn(params, carry, noise, ext, hooks)
        call_ms.append((time.perf_counter() - t0) * 1e3)  # the host's call, before the sync
        end.record()
        torch.cuda.synchronize()
        replay_ms.append(start.elapsed_time(end))
    replay_ms, call_ms = sorted(replay_ms)[1], sorted(call_ms)[1]
    last = {}

    def replay():
        last["carry"], last["out"] = fn(params, carry, noise, ext, hooks)

    acts, wall_ms = profiled_acts(replay, cpu=True)
    out = last["out"]
    if not torch.isfinite(out.audio.float()).all():
        fail("graphed profile: non-finite audio")
    names = tuple(cap.launches)
    replay_kernels = port_kernel_counts(a[2] for a in acts)
    eager_acts, eager_launches = [], {}
    for _ in range(3):  # the same window eagerly, its wrapper calls counted
        reset_counts(names)
        eager_acts, _ = profiled_acts(lambda: fn.eager(params, eager_carry, noise, ext, hooks),
                                      attempts=1)
        eager_launches = read_counts(names)
        # profiled again where the profile recorded nothing or lost records
        # (a few of ~57,000 kernels now and then), as the comparison shows
        if eager_acts and port_kernel_counts(a[2] for a in eager_acts) == replay_kernels:
            break
    eager_kernels = port_kernel_counts(a[2] for a in eager_acts)
    print(f"  graphed profile: port kernels' device activities in the replay {replay_kernels}, "
          f"in the same window run eagerly {eager_kernels}; wrapper calls of the eager window "
          f"{eager_launches}, launches recorded at capture {cap.launches}", flush=True)
    if acts and eager_acts:
        if eager_launches != cap.launches:
            fail(f"graphed profile: the capture recorded {cap.launches} launches, the eager "
                 f"window made {eager_launches}")
        if replay_kernels != eager_kernels or set(replay_kernels) != set(cap.launches):
            fail(f"graphed profile: the replay ran the port's device kernels {replay_kernels}, "
                 f"the eager window {eager_kernels} (wrappers {sorted(cap.launches)})")
    per_call = {w: eager_kernels.get(w, 0) / n for w, n in eager_launches.items()}
    print(f"  graphed window of {frames} frames at max_length 4096: {replay_ms:.3f} ms of device "
          f"time by CUDA events ({replay_ms / frames:.3f} ms a frame); the host's step_fn call "
          f"(copies in, the replay's launch) returns after {call_ms:.3f} ms", flush=True)
    if not acts:
        print("  graphed profile: the profiler recorded no device activity in three tries",
              flush=True)
        return dict(frames=frames, replay_ms=replay_ms, call_ms=call_ms, activities=0,
                    captured_launches=cap.launches)
    busy, gaps, end = 0.0, [], acts[0][0]
    for s0, s1, _ in acts:
        if s0 > end:
            gaps.append(s0 - end)
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    span_us = end - acts[0][0]
    by_name: dict = {}
    for s0, s1, name in acts:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + s1 - s0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    gaps.sort(reverse=True)
    rec = dict(frames=frames, replay_ms=replay_ms, call_ms=call_ms, activities=len(acts),
               device_span_ms=span_us / 1e3,
               device_busy_ms=busy / 1e3, busy_share_of_span=busy / span_us,
               host_wall_ms=wall_ms, busy_share_of_wall=busy / 1e3 / wall_ms,
               per_frame_device_span_ms=span_us / 1e3 / frames,
               idle_gaps=len(gaps), idle_ms=sum(gaps) / 1e3,
               largest_gaps_us=gaps[:8], captured_launches=cap.launches,
               port_device_kernels=replay_kernels, device_kernels_per_call=per_call,
               top_kernels=[dict(name=nm[:120], count=n, total_ms=t / 1e3) for nm, (n, t) in top])
    print(f"  graphed profile, one replay of a {frames}-frame window at max_length 4096: "
          f"{len(acts)} device activities over {span_us / 1e3:.3f} ms "
          f"({span_us / 1e3 / frames:.3f} ms a frame), busy {busy / 1e3:.3f} ms = "
          f"{busy / span_us:.1%} of the span and {busy / 1e3 / wall_ms:.1%} of the host's "
          f"{wall_ms:.3f} ms; {len(gaps)} idle gaps, {sum(gaps) / 1e3:.3f} ms in all, the largest "
          + ", ".join(f"{x:.1f}" for x in gaps[:8]) + " us", flush=True)
    for row in rec["top_kernels"]:
        print(f"    {row['total_ms']:8.3f} ms  {row['count']:5d} x  {row['name']}", flush=True)
    return rec


def long_prompts(model: dict, lengths=(16384, 12000)):
    """A right-padded batch of the serving script repeated, with its two
    voice prompts spliced in, one sample of exactly each length in tokens
    (filler words, one token each, top up the last line)."""
    processor, script, voices = model["processor"], model["script"], model["voices"]
    size = lambda text: processor(text=text, voice_samples=[voices]).input_ids.shape[1]
    one, two = size(script), size(script + "\n" + script)
    texts = []
    for n in lengths:
        reps = max(1, (n - one) // (two - one) + 1)
        text = "\n".join([script] * reps)
        text += " more" * (n - size(text))
        if size(text) != n:
            fail(f"could not build a {n}-token prompt")
        texts.append(text)
    return processor(text=texts, voice_samples=[voices] * len(texts))


# Phase 5's caches: (max_length, int8 KV, limit against chunked_prefill)
SP_CASES = ((32768, False, SP_TOL["bf16"]), (65536, True, SP_TOL["int8"]))


def sp_prefill_end_to_end(model: dict, seed: int, frames: int = 8, lengths=(16384, 12000),
                          cases=SP_CASES) -> dict:
    """The sequence-parallel prefill (parallel/sp_prefill.ring_prefill_carry)
    in a one-rank NCCL group on a full-width model (phase 5: the 1.5B, bf16
    KV at max_length 32768 and int8 KV at 65536), a right-padded batch of
    prompts of `lengths` tokens, each cache held against
    inference.chunked_prefill (kernel B, chunks of 2048) on the same prompt
    and followed by `frames` forced frames of the graphed step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.parallel import make_mesh, ring_prefill_carry

    cfg, params, toks = model["cfg"], model["params"], model["toks"]
    dev = torch.device("cuda")
    proc = long_prompts(model, lengths)
    ids = torch.as_tensor(proc.input_ids, device=dev)
    valid = torch.as_tensor(proc.attention_mask, device=dev)
    b = ids.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_voice, n_frames = proc.speech_masks.shape
    vae_noise = (torch.randn(n_voice, generator=g, device=dev),
                 torch.randn(n_voice, n_frames, cfg.acoustic_vae_dim, generator=g, device=dev))
    speech_args = (torch.as_tensor(proc.speech_tensors, device=dev),
                   torch.as_tensor(proc.speech_masks, device=dev),
                   torch.as_tensor(proc.speech_input_mask, device=dev), None, vae_noise)
    lengths = valid.sum(1).tolist()
    print(f"  prompts {lengths} tokens (right-padded to {ids.shape[1]}), voice prompts "
          f"{tuple(proc.speech_tensors.shape)} ({int(proc.speech_masks.sum())} latent frames)",
          flush=True)
    # the ring (kernel F, A's GEMM on 32,768 rows) and the decode frames after
    # it (A's GEMV, B's decode route, C, D); the chunked_prefill reference
    # (A's GEMM on 4,096 rows, B's prefill route on 2,048-row chunks)
    ring_names = ("flash_ring_block", "int8_matmul_gemm", "int8_matmul", "flash_cached_attention",
                  "fused_head_ffn_stack", "fused_stage_step")
    chunked_names = ("int8_matmul_gemm", "flash_cached_attention_prefill")
    nl = cfg.decoder_config.num_hidden_layers

    def cache_prefix(carry, li, kv_int8):
        """Layer li's positive-stream K and V over each sample's valid
        prefix, dequantized for int8, concatenated."""
        cache, out = carry.cache, []
        for bi, n in enumerate(lengths):
            for buf, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
                x = buf[li][bi, :, :n].float()
                if kv_int8:
                    x = x * scale[li][bi, :, 0, :n, None]
                out.append(x.flatten())
        return torch.cat(out)

    store = ROOT / "build" / "sp_prefill_pg"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    runs, total = {}, dict.fromkeys(ring_names + chunked_names, 0)
    try:
        mesh = make_mesh(dp=1, tp=1)
        for max_len, kv_int8, tol in cases:
            label = f"max_length={max_len} ({'int8' if kv_int8 else 'bf16'} KV)"
            torch.cuda.synchronize()
            reset_counts(chunked_names)
            t0 = time.perf_counter()
            ref = inf.chunked_prefill(cfg, params, ids, valid, max_len, toks, speech_args,
                                      chunk=2048, kv_int8=kv_int8)
            torch.cuda.synchronize()
            ref_wall = time.perf_counter() - t0
            ref_counts = read_counts(chunked_names)
            opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=max_len,
                                       kv_int8=kv_int8)
            hooks = {"forced": torch.full((b,), toks.speech_diffusion, device=dev),
                     "init": torch.randn(1, b, cfg.acoustic_vae_dim, generator=g, device=dev)}
            no_stop = torch.zeros(b, dtype=torch.bool, device=dev)

            reset_counts(ring_names)
            t0 = time.perf_counter()
            sp = ring_prefill_carry(cfg, params, ids, valid, max_len, toks, mesh,
                                    speech_args=speech_args, kv_int8=kv_int8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            carry, audio = sp, []
            fn = inf.make_step_fn(cfg, toks, opts, inject=True)
            noise, replays = inf.draw_noise(cfg, opts, b, g, inject=True), fn.replays
            for _ in range(frames):  # the graphed step; its outputs are static buffers
                carry, out = fn(params, carry, noise, no_stop, hooks)
                audio.append(out.audio.clone())
            torch.cuda.synchronize()
            counts = read_counts(ring_names)
            if fn.replays - replays != frames:
                fail(f"sp prefill {label}: {fn.replays - replays} graph replays for {frames} frames")

            audio = torch.stack(audio).float()  # (frames, B, hop, 1)
            if not torch.isfinite(audio).all():
                fail(f"sp prefill {label}: non-finite audio")
            peaks = audio.abs().amax(dim=(0, 2, 3)).tolist()
            if not min(peaks) > 0:
                fail(f"sp prefill {label}: a silent sample, peaks {peaks}")
            missing = [k for k, v in counts.items() if v == 0]
            if missing:
                fail(f"sp prefill {label}: kernels never launched on the main path: {missing}")
            missing = [k for k, v in ref_counts.items() if v == 0]
            if missing:
                fail(f"chunked_prefill {label}: kernels never launched: {missing}")
            if not torch.equal(sp.cache.length, ref.cache.length):
                fail(f"sp prefill {label}: cache lengths {sp.cache.length.tolist()} against "
                     f"{ref.cache.length.tolist()}")
            errs = {"h_pos": rel_err(sp.h_pos, ref.h_pos)[1]}
            for li in (0, nl - 1):
                errs[f"cache layer {li}"] = rel_err(cache_prefix(sp, li, kv_int8),
                                                    cache_prefix(ref, li, kv_int8))[1]
            print(f"  ring prefill {label}: wall {wall:.2f} s (chunked_prefill {ref_wall:.2f} s); "
                  f"against chunked_prefill, max |diff| over the peak: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (tol {tol:g}); {frames} frames, "
                  f"audio peaks {[f'{p:.3e}' for p in peaks]}; launches {counts}, "
                  f"chunked_prefill's {ref_counts}", flush=True)
            bad = {k: v for k, v in errs.items() if not v <= tol}
            if bad:
                fail(f"sp prefill {label}: disagrees with chunked_prefill: {bad}")
            for c in (counts, ref_counts):
                for k, v in c.items():
                    total[k] += v
            runs[label] = dict(prefill_wall_s=wall, chunked_prefill_wall_s=ref_wall,
                               prompt_tokens=lengths, rel_err=errs, audio_peaks=peaks,
                               launches=counts, chunked_prefill_launches=ref_counts)
            del ref, sp, carry, out, audio
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return dict(runs=runs, launches=total)


def tiny_qlora_card_vs_cpu(seed: int) -> None:
    """One QLoRA loss and its adapter gradients on the tiny config: kernels
    on the card against the plain versions on the CPU, f32, same weights,
    batch (right-padded) and random draws."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.finetune import loss as L
    from vibevoice_tpu_torch.finetune import lora as LR
    from vibevoice_tpu_torch.finetune import train_step as TS
    from vibevoice_tpu_torch.ops import quant
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config()
    hop = cfg.acoustic_tokenizer_config.hop_length
    b, t, f = 2, 96, 6
    rng = np.random.RandomState(seed)
    am = np.zeros((b, t), bool)
    am[:, 10:10 + f] = True
    valid = np.ones((b, t), bool)
    valid[1, 70:] = False
    batch = L.Batch(rng.randint(10, 100, (b, t)).astype(np.int32), valid,
                    rng.randn(b, hop * f).astype(np.float32), np.ones((b, f), bool),
                    rng.randn(b, f, cfg.semantic_vae_dim).astype(np.float32),
                    np.ones((b,), bool), am, am)
    mul = 4
    draws = L.Draws(*(torch.from_numpy(a) for a in (
        rng.randn(b).astype(np.float32), rng.randn(b, f, cfg.acoustic_vae_dim).astype(np.float32),
        rng.randn(b * t * mul, cfg.diffusion_head_config.latent_size).astype(np.float32),
        rng.randint(0, cfg.diffusion_head_config.ddpm_num_steps, b * t * mul).astype(np.int64))))
    p = init(cfg, seed=seed, device="cpu")
    p["speech_scaling_factor"] = torch.tensor(float("nan"))
    p["speech_bias_factor"] = torch.tensor(float("nan"))
    p = {**p, "lm": quant.quantize_lm(p["lm"])}
    lcfg = LR.LoraConfig(r=4)
    lora = LR.init_lora(seed, p, lcfg)
    for entry in lora["lm_layers"] + lora["diffusion_head_layers"]:
        for pair in entry.values():  # non-zero B: every adapter leaf gets a gradient
            pair["b"] = torch.from_numpy(rng.randn(*pair["b"].shape).astype(np.float32) * 0.05)
    opts = L.TrainOptions(remat=True, ce_chunk_size=32)
    grad_fn = TS.make_lora_grad_fn(cfg, lcfg, opts)
    lr = 1e-3
    init = {k: x.float() for k, x in TS.tree_leaves_with_path(lora)}

    def two_steps(dev, lr):
        """Each adapter leaf's update after two optimizer steps: lr 0 on
        the first, lr on the second (warmup 1)."""
        opt = TS.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10)
        step = TS.make_lora_train_step(cfg, opt, lcfg, opts)
        state = TS.init_train_state(_to(lora, dev), opt)
        for _ in range(2):
            state, _ = step(state, _to(p, dev), batch, draws)
        return {k: v.float().cpu() - init[k] for k, v in TS.tree_leaves_with_path(state.params)}

    res = {}
    # A on B*T = 192 rows: its GEMM; the tiny config's head_dim 16: the
    # training attention's CUDA-core route
    names = ("int8_matmul_gemm", "int8_matmul_t", "flash_train_attention_fwd_cores",
             "flash_train_attention_bwd_cores")
    for dev in ("cuda", "cpu"):
        reset_counts(names)
        loss, out, grads = grad_fn(_to(lora, dev), _to(p, dev), batch, draws)
        counts = list(read_counts(names).values())
        res[dev] = (float(loss), {k: v.float().cpu() for k, v in grads.items()}, counts,
                    two_steps(dev, lr))
    (lc, gc, counts, dc), (lp, gp, _, dp) = res["cuda"], res["cpu"]
    if min(counts) == 0:
        fail(f"tiny QLoRA on the card did not launch every training kernel: {counts}")
    worst = max(float((gc[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-12))
                for k in gp)
    # Adam maps each gradient element to about +-lr, and an element whose
    # gradient is near 0 can flip on a tiny difference; so the two updates
    # are compared as whole vectors (L2), the largest element difference
    # shown. The limit must catch two planted faults of the CPU's own step:
    # the steps at 1.01 lr, and the smallest leaf's update dropped.
    flat = lambda d: torch.cat([d[k].flatten() for k in init])
    norm = float(flat(dp).norm())
    step_rel = float((flat(dc) - flat(dp)).norm()) / norm
    lr_fault = float((flat(two_steps("cpu", 1.01 * lr)) - flat(dp)).norm()) / norm
    leaf_fault = min(float(dp[k].norm()) for k in init) / norm
    tol = 5e-3
    print(f"  tiny QLoRA card vs CPU: loss {lc:.6f} / {lp:.6f}, {len(gp)} adapter gradients, "
          f"worst rel err {worst:.3e} (tol loss 1e-4, gradients 1e-3 of the peak); two optimizer "
          f"steps (lr {lr:g}): update norm {norm:.3e}, card-CPU difference {step_rel:.3e} of it "
          f"(tol {tol:g}; largest element {float((flat(dc) - flat(dp)).abs().max()):.3e}); "
          f"planted faults on the CPU: 1.01 lr {lr_fault:.3e}, smallest leaf dropped "
          f"{leaf_fault:.3e}; launches A/E/attn fwd/attn bwd {counts}", flush=True)
    if not (math.isfinite(lc) and abs(lc - lp) <= 1e-4 * abs(lp)):
        fail("tiny QLoRA: the card's loss disagrees with the CPU's")
    if not worst <= 1e-3:
        fail("tiny QLoRA: the card's adapter gradients disagree with the CPU's")
    if not (lr_fault > tol and leaf_fault > tol):
        fail("tiny QLoRA: the optimizer-step limit would not catch a planted fault")
    if not (float(flat(dp).abs().max()) > 0.1 * lr and step_rel <= tol):
        fail("tiny QLoRA: the card's optimizer steps disagree with the CPU's")


# Phase 7's trainer runs on the 1.5B: (label, arguments)
FINETUNE_RUNS = (
    ("B2 T2048", ["--per_device_batch_size", "2", "--max_length", "2048",
                  "--pad_to_multiple", "2048", "--synthetic_seconds", "220", "250",
                  "--max_steps", "3"]),
    ("B1 T8192 remat ce1024", ["--per_device_batch_size", "1", "--max_length", "8192",
                               "--pad_to_multiple", "8192", "--synthetic_seconds", "1000",
                               "1060", "--max_steps", "2", "--remat", "--ce_chunk_size", "1024"]))


def finetune_end_to_end(seed: int, config: Path = CONFIG_1P5B, runs=FINETUNE_RUNS) -> dict:
    """The port's trainer on a full-width config (the 1.5B's by default),
    QLoRA, synthetic clips sized to fill the sequence: phase 7's runs are 3
    steps at B 2, T 2048 (trainer defaults), 2 steps at B 1, T 8192 with
    remat and chunked CE. A run writes no checkpoint unless its arguments
    name an --output_dir."""
    import torch

    from vibevoice_tpu_torch.finetune import train
    from vibevoice_tpu_torch.finetune.train_step import tree_leaves_with_path

    names = ("int8_matmul_gemm", "int8_matmul_t", "flash_train_attention_fwd",
             "flash_train_attention_bwd")  # A on B*T = 4,096 or 8,192 f32 rows: its GEMM
    core_names = ("flash_train_attention_fwd_cores", "flash_train_attention_bwd_cores")
    common = ["--config", str(config),
              "--synthetic_data", "--synthetic_items", "4", "--use_lora", "--int8_base",
              "--seed", str(seed), "--device", "cuda", "--log_steps", "1"]
    recs = {}
    for label, extra in runs:
        torch.cuda.empty_cache()
        reset_counts(names + core_names)
        t0 = time.perf_counter()
        # a run given --output_dir writes its checkpoint (phase 14's merge reads it)
        summary = train.main(common + ([] if "--output_dir" in extra else ["--no_save"]) + extra)
        wall = time.perf_counter() - t0
        counts = read_counts(names)
        cores = read_counts(core_names)
        if any(cores.values()):
            fail(f"fine-tune {label}: the training attention took the CUDA-core route at head_dim "
                 f"128: {cores}")
        steps = summary["steps"]
        if not all(math.isfinite(s["loss"]) for s in steps):
            fail(f"fine-tune {label}: non-finite loss {[s['loss'] for s in steps]}")
        init = dict(tree_leaves_with_path(summary["lora_init"]))
        moved = max(float((x - init[p]).abs().max())
                    for p, x in tree_leaves_with_path(summary["lora"]) if p[-1] == "b")
        if not moved > 0:
            fail(f"fine-tune {label}: the adapters did not move after step 2")
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            fail(f"fine-tune {label}: kernels never launched on the training path: {missing}")
        timed = steps[1:]  # step 1 pays one-time allocator and library set-up
        sec = sum(s["seconds"] for s in timed) / len(timed)
        rec = dict(steps=steps, seconds_per_step=sec, tokens_per_second=steps[-1]["tokens"] / sec,
                   valid_tokens_per_second=sum(s["valid_tokens"] for s in timed) / sum(
                       s["seconds"] for s in timed),
                   peak_gib=summary["peak_bytes"] / 2**30, wall_s=wall, launches=counts,
                   b_factor_moved=moved,
                   data_seconds_per_step=sum(s["data_seconds"] for s in timed) / len(timed))
        recs[label] = rec
        print(f"  fine-tune {label}: losses {[round(s['loss'], 4) for s in steps]}, "
              f"{sec:.3f} s/step (steps 2..{len(steps)}; step 1 {steps[0]['seconds']:.3f} s), "
              f"{rec['tokens_per_second']:.0f} tokens/s ({rec['valid_tokens_per_second']:.0f} "
              f"valid), collation {rec['data_seconds_per_step']:.2f} s/step between steps, "
              f"peak {rec['peak_gib']:.2f} GiB, B factors moved {moved:.3e}, "
              f"launches {counts} (CUDA-core route {cores})", flush=True)
    return recs


def streaming_model(seed: int) -> dict:
    """The full-width streaming 0.5B set-up (tts.StreamingTTS.random): the
    config from the port's JSON, random bf16 weights from --seed with the
    vocoder's stage 0 packed int8 for kernel D, the streaming processor
    over the hash-bucket tokenizer, and a voice preset that
    build_voice_preset prefills from a random 256-token prompt at 8,192
    slots: one chunk through the 4 + 20 layers (kernel B's prefill route at
    W = 256), the one-token negative prompt through its decode route."""
    import torch

    from vibevoice_tpu_torch.tts import StreamingTTS

    names = ("flash_cached_attention", "flash_cached_attention_prefill")
    reset_counts(names)
    t0 = time.perf_counter()
    tts = StreamingTTS.random(str(CONFIG_0P5B), seed=seed, max_len=STREAM_MAX_LEN,
                              preset_tokens=STREAM_PRESET)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = read_counts(names)
    cfg = tts.cfg
    n_layers = cfg.decoder_config.num_hidden_layers
    if counts != {"flash_cached_attention": n_layers, "flash_cached_attention_prefill": n_layers}:
        fail(f"voice preset: kernel B launches {counts}, not {n_layers} of each route")
    print(f"  0.5B streaming params (bf16, {cfg.lm_num_hidden_layers} + "
          f"{cfg.tts_backbone_num_hidden_layers} layers, fused int8 vocoder stage 0) and a voice "
          f"preset from a {STREAM_PRESET}-token prompt at {STREAM_MAX_LEN} slots built in "
          f"{build_s:.3f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; preset "
          f"launches {counts}", flush=True)
    return dict(cfg=cfg, params=tts.params, processor=tts.processor, preset=tts.preset,
                hop=cfg.acoustic_tokenizer_config.hop_length, sr=24_000,
                preset_build=dict(seconds=build_s, launches=counts))


def with_eos_bias(params: dict, bias: float) -> dict:
    """The streaming params with the EOS classifier's output bias at `bias`
    (a new params object: new CUDA-graph captures)."""
    import torch

    eos = params["tts_eos_classifier"]
    return {**params, "tts_eos_classifier": {
        **eos, "fc2": {**eos["fc2"], "b": torch.full_like(eos["fc2"]["b"], bias)}}}


def streaming_end_to_end(model: dict, seed: int) -> dict:
    """The streaming 0.5B's main path: StreamingTTS.stream() at batch 1
    (preset splice, 5-token text windows interleaved with 6-frame speech
    windows, the default options: cfg 1.5, 5 DDPM steps) on the script
    STREAM_SCRIPT (one token a word, ~40 tokens).

    Random weights give a random EOS, so the timed runs set the EOS
    classifier's output bias to -30 (EOS never fires) and stop through
    stop_check_fn after STREAM_WINDOWS windows (36 frames). After warmup()
    (which captures the text and speech windows), the graphed stream is
    timed three times at 6 windows and three at 1: time to first audio
    (from the stream() call to its first chunk), ms a frame from the two
    walls' difference over 30 frames (text windows included), RTF of the
    6-window run. The same runs through the windows' eager calls
    (models.streaming.generate with each WindowFn's eager) must give the
    same audio within GRAPH_TOL of the peak and the same launch counts;
    kernel B (both routes) and D must launch; the audio must be finite and
    not silent. CUDA events time one replayed text window and one speech
    window. One run with the bias at +30 must stop at the first frame of the
    first window (one frame of audio), and one 6-window stream at 16,384
    slots (int8 KV, on by default from that length) must complete."""
    import itertools

    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import streaming as st
    from vibevoice_tpu_torch.tts import StreamingTTS

    cfg, processor, preset, hop, sr = (model[k] for k in ("cfg", "processor", "preset", "hop",
                                                            "sr"))
    params = with_eos_bias(model["params"], -30.0)
    names = ("flash_cached_attention", "flash_cached_attention_prefill", "fused_stage_step")
    tts = StreamingTTS(cfg, params, processor, preset, max_len=STREAM_MAX_LEN)
    opts = tts._opts(None, {})
    fns = st.make_window_fns(cfg, opts)[0].fns
    text_ids = processor.process_input_with_cached_prompt(STREAM_SCRIPT, preset).tts_text_ids
    print(f"  script of {text_ids.shape[1]} tokens; {STREAM_WINDOWS} windows of 5 text tokens and "
          f"6 frames ({STREAM_WINDOWS * 6 * hop / sr:.2f} s of audio)", flush=True)

    def check_audio(label, audio, frames):
        if audio is None or audio.size != frames * hop:
            fail(f"{label}: {0 if audio is None else audio.size} samples, not {frames} frames")
        if not np.isfinite(audio).all():
            fail(f"{label}: non-finite audio")
        if not np.abs(audio).max() > 0:
            fail(f"{label}: all-zero audio")

    def graphed(t, windows):
        calls = itertools.count()
        reset_counts(names)
        replays = fns.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, chunks = None, []
        for chunk in t.stream(STREAM_SCRIPT, seed=seed,
                              stop_check_fn=lambda: next(calls) >= windows):
            if first is None:
                first = time.perf_counter() - t0
            chunks.append(chunk)
        wall = time.perf_counter() - t0
        audio = np.concatenate(chunks) if chunks else None
        return audio, wall, first, read_counts(names), fns.replays - replays

    def eager(windows):
        calls = itertools.count()
        reset_counts(names)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = st.generate(cfg, params, tts_text_ids=text_ids, preset=preset, opts=opts,
                          max_len=STREAM_MAX_LEN, seed=seed,
                          stop_check_fn=lambda: next(calls) >= windows,
                          window_fns=(fns.text.eager, fns.speech.eager, fns.single.eager))
        torch.cuda.synchronize()
        return out.speech_outputs[0], time.perf_counter() - t0, read_counts(names)

    torch.cuda.synchronize()
    warm_s = tts.warmup()
    print(f"  warmup() (captures the text and the speech window): {warm_s:.3f} s", flush=True)
    frames = 6 * STREAM_WINDOWS
    long_runs = [graphed(tts, STREAM_WINDOWS) for _ in range(3)]
    short_runs = [graphed(tts, 1) for _ in range(3)]
    audio, _, _, counts, replays = long_runs[0]
    check_audio("graphed stream", audio, frames)
    for a, _, _, c, _ in long_runs[1:]:
        if not np.array_equal(a, audio) or c != counts:
            fail("graphed stream: two runs of one seed differ")
    missing = [n for n, v in counts.items() if v == 0]
    if missing:
        fail(f"graphed stream: kernels never launched on the main path: {missing}")
    if replays != 2 * STREAM_WINDOWS:
        fail(f"graphed stream: {replays} graph replays, not {2 * STREAM_WINDOWS}")
    walls = sorted(r[1] for r in long_runs)
    short_walls = sorted(r[1] for r in short_runs)
    ttfa = sorted(r[2] for r in long_runs + short_runs)
    per_frame = (walls[1] - short_walls[1]) / (frames - 6)
    e_audio, e_wall, e_counts = eager(STREAM_WINDOWS)
    e_short = eager(1)[1]
    check_audio("eager stream", e_audio, frames)
    err = float(np.abs(audio - e_audio).max() / np.abs(e_audio).max())
    print(f"  graphed against eager: audio max |diff| {err:.3e} of the peak (tol {GRAPH_TOL:g}), "
          f"launches {'equal' if counts == e_counts else 'DIFFER'} {counts}", flush=True)
    if not err <= GRAPH_TOL:
        fail(f"streaming: graphed audio differs from eager by {err:.3e} of the peak")
    if counts != e_counts:
        fail(f"streaming: launches {counts} graphed against {e_counts} eager")
    e_per_frame = (e_wall - e_short) / (frames - 6)
    seconds = frames * hop / sr
    rec = dict(frames=frames, audio_seconds=seconds, warmup_s=warm_s,
               ttfa_ms=[t * 1e3 for t in ttfa], wall_s=walls, short_wall_s=short_walls,
               per_frame_ms=per_frame * 1e3, rtf=seconds / walls[1], replays=replays,
               eager_wall_s=e_wall, eager_short_wall_s=e_short,
               eager_per_frame_ms=e_per_frame * 1e3, eager_rtf=seconds / e_wall,
               graphed_vs_eager_rel_err=err, launches=counts,
               peak_abs=float(np.abs(audio).max()))
    print(f"  stream() graphed, {frames} frames ({seconds:.2f} s audio): time to first audio "
          f"{ttfa[len(ttfa) // 2] * 1e3:.2f} ms (median of 6; "
          f"{', '.join(f'{t * 1e3:.2f}' for t in ttfa)}), walls {', '.join(f'{w:.4f}' for w in walls)} s "
          f"(1 window: {', '.join(f'{w:.4f}' for w in short_walls)}), {per_frame * 1e3:.2f} ms a "
          f"frame, RTF {rec['rtf']:.3f}; eager {e_wall:.3f} s (1 window {e_short:.3f}), "
          f"{e_per_frame * 1e3:.2f} ms a frame, RTF {rec['eager_rtf']:.3f}", flush=True)

    # one replayed text window and one speech window by CUDA events
    state = st.init_stream_state(cfg, params, preset, STREAM_MAX_LEN)
    ids = torch.as_tensor(text_ids[:, :5], device="cuda")
    valid = torch.ones(1, 5, dtype=torch.bool, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    noise = inf.FrameNoise(torch.randn(6, 1, cfg.acoustic_vae_dim, generator=g, device="cuda"),
                           None, None)
    times = {"text": [], "speech": []}
    with fns.request():
        for _ in range(3):
            for kind in ("text", "speech"):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                if kind == "text":
                    state = fns.text(params, state, ids, valid)
                else:
                    state, _, _ = fns.speech(params, state, noise)
                end.record()
                torch.cuda.synchronize()
                times[kind].append(start.elapsed_time(end))
    rec["text_window_ms"], rec["speech_window_ms"] = sorted(times["text"]), sorted(times["speech"])
    print(f"  one replayed window by CUDA events: text {rec['text_window_ms'][1]:.3f} ms, speech "
          f"(6 frames) {rec['speech_window_ms'][1]:.3f} ms = "
          f"{rec['speech_window_ms'][1] / 6:.3f} ms a frame (medians of 3)", flush=True)

    # EOS at the first frame: the bias at +30
    eos_audio = StreamingTTS(cfg, with_eos_bias(model["params"], 30.0), processor, preset,
                             max_len=STREAM_MAX_LEN).synthesize(STREAM_SCRIPT, seed=seed)
    check_audio("EOS at +30", eos_audio, 1)
    print(f"  EOS bias +30: {eos_audio.size // hop} frame kept (the first of the first window)",
          flush=True)
    rec["eos_run_frames"] = eos_audio.size // hop

    # int8 KV: 16,384 slots
    tts16 = StreamingTTS(cfg, params, processor, preset, max_len=16384)
    if not inf.resolve_kv_int8(opts, 16384).kv_int8:
        fail("16384 slots: int8 KV is not on")
    warm16 = tts16.warmup()
    a16, wall16, first16, counts16, _ = graphed(tts16, STREAM_WINDOWS)
    check_audio("int8 KV stream", a16, frames)
    missing = [n for n, v in counts16.items() if v == 0]
    if missing:
        fail(f"int8 KV stream: kernels never launched: {missing}")
    if counts16 != counts:
        fail(f"int8 KV stream: launches {counts16}, the bf16 stream's {counts}")
    rec["int8_kv_16384"] = dict(warmup_s=warm16, wall_s=wall16, ttfa_ms=first16 * 1e3,
                                rtf=seconds / wall16, launches=counts16,
                                peak_abs=float(np.abs(a16).max()))
    print(f"  stream() at 16384 slots (int8 KV), after warmup() ({warm16:.3f} s): {wall16:.4f} s "
          f"for {frames} frames, RTF {seconds / wall16:.3f}, time to first audio "
          f"{first16 * 1e3:.2f} ms, launches {counts16}", flush=True)
    return dict(runs=rec, launches=counts)


# Phase 8: the continuous-batching engine on the full-width 1.5B. Its
# requests are the two-speaker prompt with its two voices, each capped at
# ENGINE_FRAMES frames; utils.params.speaking makes the random weights
# diffuse at every frame (greedy), so each request gives exactly its cap of
# audio through the production path (the engine's own draws, no forced
# tokens). The request in slot 3 is held, on the noise rows its slot was
# given, to the same request decoded alone in the same engine (the same
# batch shape: GRAPH_TOL, rows do not mix) and to its run alone from a
# batch-1 carry: there kernels A-D and cuBLAS take other plans at 2 rows
# than at 8 (kernel A's GEMV tiles and K splits, B's splits, C's and D's
# row tiles), so bf16 roundings differ and the frames drift apart. On an
# H100 (--seed 0) the batch-1 run read 2.0e-2 and 2.1e-2 of the peak through
# the first window of 4 frames, and 1.09e-1 and 1.72e-1 through all 40 (the
# rows a slot is given depend on the windows drawn before, so the reading
# moves between runs); another request's audio (other noise rows, printed
# beside) read 1.25-1.36. ENGINE_SOLO_FIRST_TOL and ENGINE_SOLO_TOL sit
# between the two.
ENGINE_BATCH = 4
ENGINE_FRAMES = 40
ENGINE_SOLO_FIRST_TOL = 5e-2
ENGINE_SOLO_TOL = 0.4
ENGINE_NAMES = ("int8_matmul", "int8_matmul_gemm", "flash_cached_attention",
                "flash_cached_attention_prefill", "fused_head_ffn_stack", "fused_stage_step")
# Phase 9: the session engine on the full-width 0.5B. An inject-mode
# session batched with three others is held to itself alone in the same
# engine (GRAPH_TOL) and to its solo streaming.generate() at batch 1, where
# the 8-row and 1-row bf16 products round differently: 1.44e-2 of the peak
# over 36 frames on an H100 (--seed 0); SESSION_SOLO_TOL sits above it.
SESSION_SOLO_TOL = 5e-2
SESSION_SLOTS = 8
SESSION_FRAMES = 36
SESSION_NAMES = ("flash_cached_attention", "flash_cached_attention_prefill", "fused_stage_step")


def record_noise_rows(eng) -> tuple:
    """Keep the initial-latent rows every window's draw gives each busy slot
    of ``eng``: returns (rows: handle -> [(slot step, slot, rows (K, D))],
    the engine's own draw, which the caller puts back)."""
    rows: dict = {}
    draw = eng._draw_noise

    def recording_draw():
        noise = draw()
        for i, h in enumerate(eng.slots):
            if h is not None:
                rows.setdefault(h, []).append((int(eng.slot_steps[i]), i, noise.init[:, i].clone()))
        return noise

    eng._draw_noise = recording_draw
    return rows, draw


def run_alone_on_rows(eng, request, recorded: list, draw):
    """``request`` decoded alone in ``eng`` (the other slots idle), its slot
    given at each step the rows ``recorded`` for it in an earlier run
    (record_noise_rows), so that it must repeat that run's audio; ``draw``
    is the engine's own draw, put back afterwards."""
    by_step = {step: init for step, _, init in recorded}

    def replay_draw():
        noise = draw()
        for i, h in enumerate(eng.slots):
            if h is not None:
                noise.init[:, i] = by_step[int(eng.slot_steps[i])]
        return noise

    eng._draw_noise = replay_draw
    try:
        return eng.submit(request).result(timeout=600)
    finally:
        eng._draw_noise = draw


def serving_engine_end_to_end(model: dict, seed: int) -> dict:
    """Phase 8: ServingEngine(max_batch=4, max_len=4096, frames_per_dispatch
    =4, reserved_slots=1) over the speaking 1.5B (bf16, int8 LM + lm_head,
    fused serving packs), after warmup(): eight requests (seeds 0-7), four
    at once (one with priority, in the express slot) and four staggered
    (each submitted at the previous one's first audio), one cancelled at its
    first audio. Every request ends as expected with its frame cap of audio
    (the cancelled one with less), stats() agrees; the request in slot 3
    gives the bits of the same request alone in the engine on the same
    noise rows, and the tokens of its run from its own batch-1 carry with
    audio within ENGINE_SOLO_TOL; one batched window replayed by the engine's graph gives
    the tokens, audio bits and launch counts of the same window run
    eagerly. Then the aggregate audio seconds per wall second of eight
    requests at once, against the same engine at max_batch=1, TTFA
    percentiles, one replay's device time a frame (CUDA events), and a
    short run at 65,536 slots (int8 KV) joining four requests."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.engine import Request, ServingEngine
    from vibevoice_tpu_torch.utils.params import speaking

    cfg, toks, hop, sr = (model[k] for k in ("cfg", "toks", "hop", "sr"))
    params = speaking(model["params"], toks, c=64.0)
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    n = int(proc.attention_mask.sum())
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096)
    k = 4

    def request(s, frames=ENGINE_FRAMES, **kw):
        return Request(input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                       speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                       speech_input_mask=proc.speech_input_mask, seed=s,
                       max_length_times=(frames + 0.5) / n, **kw)

    def engine(**kw):
        eng = ServingEngine(cfg, params, tokens=toks, opts=opts, frames_per_dispatch=k, **kw)
        t0 = time.perf_counter()
        warm = eng.warmup()
        return eng, time.perf_counter() - t0, warm

    def check_audio(label, audio, frames):
        if (audio.size != frames * hop or not np.isfinite(audio).all()
                or not np.abs(audio).max() > 0):
            fail(f"{label}: {audio.size} samples (not {frames} frames of {hop}), or not finite, "
                 "or silent")

    eng, warm_s, _ = engine(max_batch=ENGINE_BATCH, max_len=4096, reserved_slots=1)
    print(f"  engine at max_batch {ENGINE_BATCH}, 4096 slots, K {k}, reserved_slots 1: warmup() "
          f"{warm_s:.3f} s (builds, captures the window); prompt {n} tokens, "
          f"{ENGINE_FRAMES} frames a request", flush=True)
    rows, draw = record_noise_rows(eng)  # the draws each slot was given
    prefill_s: list = []  # each request's prefill wall on the prefill thread
    prefill = eng._prefill

    def timed_prefill(r):
        t = time.perf_counter()
        out = prefill(r)
        prefill_s.append(time.perf_counter() - t)
        return out

    eng._prefill = timed_prefill
    frames0, replays0 = eng.stats().frames_emitted, eng.step_fn.replays
    reset_counts(ENGINE_NAMES)
    t0 = time.perf_counter()
    # the burst is staged behind the step function's lock until two of its
    # prefills wait in `ready`: one prefill takes longer than a request's
    # 40 frames beside a decoding slot, so unstaged the first request ends
    # before the last joins and slot 3 is never used
    with eng.step_fn.request():
        handles = [eng.submit(request(s)) for s in range(3)]
        handles.append(eng.submit(request(3, priority=True)))
        if not eng.wait_for_state(eng.ready.full, 300):
            fail("serving engine: the burst's prefills were not staged in 300 s")
    for s in range(4, 8):
        prev = handles[-1]
        if not eng.wait_for_state(lambda: prev.first_audio_time is not None or prev._done.is_set(),
                                  300):
            fail(f"serving engine: request {s - 1} gave no audio in 300 s")
        handles.append(eng.submit(request(s)))
        if s == 5:
            h5 = handles[-1]
            if not eng.wait_for_state(lambda: h5.first_audio_time is not None, 300):
                fail("serving engine: request 5 gave no audio in 300 s")
            h5.cancel()
    audio = [h.result(timeout=600) for h in handles]
    traffic_s = time.perf_counter() - t0
    traffic_counts = read_counts(ENGINE_NAMES)
    for s, (h, a) in enumerate(zip(handles, audio)):
        want = "cancelled" if s == 5 else "completed"
        if h.rec["outcome"] != want:
            fail(f"serving engine: request {s} ended {h.rec['outcome']}, not {want}")
        if s == 5:
            if not (0 < a.size < ENGINE_FRAMES * hop and a.size % hop == 0):
                fail(f"serving engine: the cancelled request has {a.size} samples")
        else:
            check_audio(f"serving engine request {s}", a, ENGINE_FRAMES)
    st = eng.stats()
    emitted = sum(a.size for a in audio) // hop
    if (st.submitted, st.completed, st.cancelled, st.failed, st.active,
            st.frames_emitted - frames0, st.priority_submitted) != (8, 7, 1, 0, 0, emitted, 1):
        fail(f"serving engine: stats {st} disagree (8 submitted, 7 completed, 1 cancelled, "
             f"{emitted} frames)")
    express = {slot for _, slot, _ in rows[handles[3]]}
    if express != {0}:
        fail(f"serving engine: the priority request ran in slots {express}, not the express slot 0")
    print(f"  8 requests (4 at once, one priority; 4 staggered, one cancelled) in "
          f"{traffic_s:.3f} s: "
          f"{emitted} frames, outcomes right, stats agree; TTFA p50 {st.ttfa_p50_ms:.1f} ms, p95 "
          f"{st.ttfa_p95_ms:.1f} ms; prefill walls (on the prefill thread, beside decoding) "
          f"{', '.join(f'{t:.3f}' for t in prefill_s)} s; {eng.step_fn.replays - replays0} "
          f"replays, launches {traffic_counts}", flush=True)

    # the request in slot 3 against its run alone on the same noise rows
    h3 = next(h for h in handles if h.rec["outcome"] == "completed" and rows[h][0][1] == 3)
    solo_fn = inf.StepFn(cfg, toks, inf._trace_opts(opts), k, True)
    g = torch.Generator(device="cuda")
    g.manual_seed(h3.request.seed)
    r = h3.request
    carry = inf.prefill_request(cfg, params, r.input_ids, r.valid_mask, r.speech_tensors,
                                r.speech_frame_valid, r.speech_input_mask, 4096, toks, eng.opts, g)
    cap = min(4096 - n, int(r.max_length_times * n))
    solo_toks, solo_audio, done = [], [], False
    for step, _, init in sorted(rows[h3], key=lambda t: t[0]):
        ext = torch.as_tensor(np.arange(step, step + k)[:, None] >= cap, device="cuda")
        carry, out = solo_fn(params, carry, inf.FrameNoise(init[:, None], None, None), ext)
        toks_k, mask, a, fin = (t.cpu().numpy() for t in (out.tokens, out.audio_mask,
                                                             out.audio.float(), out.finished))
        for f in range(k):
            if done:
                break
            solo_toks.append(int(toks_k[f, 0]))
            if mask[f, 0]:
                solo_audio.append(a[f, 0, :, 0])
            done = bool(fin[f, 0])
    solo = np.concatenate(solo_audio) if solo_audio else np.zeros(0, np.float32)
    got = audio[handles.index(h3)]
    if solo.shape != got.shape:
        fail(f"serving engine: the slot-3 request has {got.size} samples, its run alone "
             f"{solo.size}")
    peak = float(np.abs(solo).max())
    curve = [float(np.abs(got[: f * hop] - solo[: f * hop]).max() / peak)
             for f in range(k, ENGINE_FRAMES + 1, k)]  # through each window
    solo_err = curve[-1]
    print(f"  request {handles.index(h3)} in slot 3 against its run alone (batch 1, the same noise "
          f"rows): tokens {'equal' if solo_toks == h3.tokens else 'DIFFER'} ({len(solo_toks)}), "
          f"audio max |diff| over the peak through each window of {k} frames "
          f"{', '.join(f'{e:.2e}' for e in curve)} (tol {ENGINE_SOLO_FIRST_TOL:g} for the first "
          f"window, {ENGINE_SOLO_TOL:g} for all)", flush=True)
    if solo_toks != h3.tokens or not (curve[0] <= ENGINE_SOLO_FIRST_TOL
                                      and solo_err <= ENGINE_SOLO_TOL):
        fail("serving engine: the slot-3 request differs from its run alone")
    del solo_fn, carry
    # the same request alone in the same engine, its slot given the same rows
    alone = run_alone_on_rows(eng, request(h3.request.seed), rows[h3], draw)
    alone_err = float(np.abs(alone - got).max() / np.abs(got).max()) \
        if alone.shape == got.shape else float("inf")
    other = next(a for h, a in zip(handles, audio) if h is not h3 and a.size == got.size)
    fault = float(np.abs(other - got).max() / np.abs(got).max())
    print(f"  the same request alone in the engine (the same rows, other slots idle): max |diff| "
          f"{alone_err:.3e} of the peak (tol {GRAPH_TOL:g}); another request's audio (other "
          f"noise rows) reads {fault:.3e}", flush=True)
    if not alone_err <= GRAPH_TOL or not fault > ENGINE_SOLO_TOL:
        fail("serving engine: the slot-3 request differs from itself alone in the engine, or the "
             "tolerance does not separate another request's audio")

    # one batched window, graphed against eager, from the engine's carry with
    # every slot active again; then one replay's device time
    fn, b = eng.step_fn, ENGINE_BATCH
    clone = lambda c: inf._tree_map(lambda t: t.clone(), c)
    start = clone(eng.carry)
    start.finished.zero_()
    noise = clone(draw())
    ext = torch.zeros(k, b, dtype=torch.bool, device="cuda")
    reset_counts(ENGINE_NAMES)
    _, out_e = fn.eager(params, clone(start), noise, ext)
    e_counts = read_counts(ENGINE_NAMES)
    out_e = clone(out_e)
    reset_counts(ENGINE_NAMES)
    _, out_g = fn(params, clone(start), noise, ext)
    g_counts = read_counts(ENGINE_NAMES)
    torch.cuda.synchronize()
    same = (torch.equal(out_g.tokens, out_e.tokens) and torch.equal(out_g.audio, out_e.audio)
            and torch.equal(out_g.finished, out_e.finished))
    times = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn(params, eng.carry, noise, ext)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]) / k)
    eng.carry.finished.fill_(True)  # the slots are free again
    print(f"  one window of {k} frames x {b} slots replayed against eager: tokens and audio "
          f"{'the same bits' if same else 'DIFFER'}, launches "
          f"{'equal' if g_counts == e_counts else 'DIFFER'} {g_counts}; device time "
          f"{sorted(times)[1]:.3f} ms a frame (CUDA events, median of 3: "
          f"{', '.join(f'{t:.3f}' for t in times)})", flush=True)
    if not same or g_counts != e_counts:
        fail("serving engine: a replayed window differs from its eager run")

    # throughput: eight requests at once (priority: any of the 4 slots), then
    # the same at max_batch=1
    def burst(e, label):
        reset_counts(ENGINE_NAMES)
        t = time.perf_counter()
        hs = [e.submit(request(10 + i, priority=True)) for i in range(8)]
        out = [h.result(timeout=900) for h in hs]
        wall = time.perf_counter() - t
        for i, a in enumerate(out):
            check_audio(f"{label} request {i}", a, ENGINE_FRAMES)
        secs = sum(a.size for a in out) / sr
        ttfa = sorted(h.rec["ttfa_ms"] for h in hs)
        return dict(wall_s=wall, audio_s=secs, rtf=secs / wall, ttfa_ms=ttfa,
                    launches=read_counts(ENGINE_NAMES))

    bs4 = burst(eng, "bs4")
    for name, v in traffic_counts.items():
        bs4["launches"][name] += v
    eng1, warm1, _ = engine(max_batch=1, max_len=4096)
    bs1 = burst(eng1, "bs1")
    eng1.shutdown()
    del eng1
    print(f"  8 requests at once ({8 * ENGINE_FRAMES} frames, prefill included): max_batch 4 "
          f"{bs4['wall_s']:.3f} s, {bs4['rtf']:.2f} audio s a wall s (TTFA "
          f"{bs4['ttfa_ms'][3]:.0f}-{bs4['ttfa_ms'][-1]:.0f} ms); max_batch 1 "
          f"{bs1['wall_s']:.3f} s, "
          f"{bs1['rtf']:.2f} (TTFA {bs1['ttfa_ms'][3]:.0f}-{bs1['ttfa_ms'][-1]:.0f} ms); "
          f"{bs4['rtf'] / bs1['rtf']:.2f}x", flush=True)

    # int8 KV: 65,536 slots, four requests joined
    eng65, warm65, _ = engine(max_batch=ENGINE_BATCH, max_len=65536)
    if eng65.carry.cache.k[0].dtype != torch.int8:
        fail("serving engine at 65536 slots: the KV cache is not int8")
    t = time.perf_counter()
    hs = [eng65.submit(request(30 + i, frames=16)) for i in range(4)]
    a65 = [h.result(timeout=600) for h in hs]
    wall65 = time.perf_counter() - t
    for i, a in enumerate(a65):
        check_audio(f"65536-slot request {i}", a, 16)
    eng65.shutdown()
    del eng65
    print(f"  65536 slots (int8 KV), warmup {warm65:.3f} s: 4 requests of 16 frames joined and "
          f"decoded in {wall65:.3f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    eng._draw_noise, eng._prefill = draw, prefill
    return dict(engine=eng, params=params, runs=dict(
        warmup_s=warm_s, traffic_s=traffic_s, frames=emitted, prefill_s=prefill_s,
        ttfa_p50_ms=st.ttfa_p50_ms, ttfa_p95_ms=st.ttfa_p95_ms, solo_rel_err_by_window=curve,
        alone_in_engine_rel_err=alone_err, other_request_rel_diff=fault,
        window_device_ms_per_frame=sorted(times), window_launches=g_counts, bs4=bs4, bs1=bs1,
        bs1_warmup_s=warm1, int8_65536=dict(warmup_s=warm65, wall_s=wall65)),
        launches=bs4["launches"])


def session_engine_end_to_end(model: dict, seed: int) -> dict:
    """Phase 9: StreamingSessionEngine(n_slots=8, max_len=8192, quantum=3)
    over the full-width 0.5B of phase 6 (EOS held off: bias -30), after a
    warm-up session: 12 sessions of STREAM_SCRIPT (4 queue behind the 8
    slots) and a live one whose script arrives in three parts (two
    append_text calls, then end_text), each capped at SESSION_FRAMES frames.
    Every session completes with its cap of frames; join-TTFA percentiles,
    quantum walls against the real-time budget, the aggregate real-time
    factor and the launches of kernels B and D are printed. Then one
    session in inject mode, batched with three others, against itself
    alone in the engine (GRAPH_TOL) and its solo streaming.generate() with
    the same noise bank (SESSION_SOLO_TOL)."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import streaming as st
    from vibevoice_tpu_torch.serving.streaming_sessions import StreamingSessionEngine

    cfg, processor, preset, hop, sr = (model[k] for k in ("cfg", "processor", "preset", "hop",
                                                            "sr"))
    params = with_eos_bias(model["params"], -30.0)
    opts = inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=5)

    def engine(**kw):
        return StreamingSessionEngine(cfg, params, n_slots=SESSION_SLOTS, max_len=STREAM_MAX_LEN,
                                      quantum=3, opts=opts, default_preset=preset,
                                      processor=processor, seed=seed, **kw)

    eng = engine()
    warm_s = eng.warmup(timeout=300)
    text = processor.process_input_with_cached_prompt(STREAM_SCRIPT, preset).tts_text_ids[0]
    reset_counts(SESSION_NAMES)
    windows0, replays0 = eng.windows_run, eng.fns.replays
    t0 = time.perf_counter()
    hs = [eng.submit(text, max_new_frames=SESSION_FRAMES) for _ in range(12)]
    parts = np.array_split(text, 3)
    live = eng.submit(parts[0], live=True, max_new_frames=SESSION_FRAMES)
    frames = live.frames(timeout=300)
    got = [next(frames)]
    live.append_text(parts[1])
    got += [next(frames) for _ in range(5)]
    live.append_text(parts[2])
    live.end_text()
    got += list(frames)
    audio = [h.result(timeout=300) for h in hs] + [np.concatenate(got)]
    wall = time.perf_counter() - t0
    counts = read_counts(SESSION_NAMES)
    for i, a in enumerate(audio):
        if a.size != SESSION_FRAMES * hop or not np.isfinite(a).all() or not np.abs(a).max() > 0:
            fail(f"session engine: session {i} has {a.size} samples (not {SESSION_FRAMES} "
                 "frames), or is not finite, or silent")
    if any(h.rec["outcome"] != "completed" for h in hs + [live]):
        fail(f"session engine: outcomes {[h.rec['outcome'] for h in hs + [live]]}")
    stats = eng.stats()
    secs = sum(a.size for a in audio) / sr
    missing = [n_ for n_, v in counts.items() if v == 0]
    if missing:
        fail(f"session engine: kernels never launched: {missing}")
    print(f"  {len(audio)} sessions ({SESSION_SLOTS} slots, quantum 3, one live in three parts) "
          f"after a warm-up session ({warm_s:.3f} s): {secs:.2f} s of audio in {wall:.3f} s, "
          f"aggregate RTF {secs / wall:.2f}; join-TTFA p50 {stats['ttfa_p50_ms']} ms, p95 "
          f"{stats['ttfa_p95_ms']} ms; quantum wall p50 {stats['window_p50_ms']} ms, p95 "
          f"{stats['window_p95_ms']} ms (budget {stats['window_budget_ms']} ms); "
          f"{eng.windows_run - windows0} quanta, {eng.fns.replays - replays0} replays, launches "
          f"{counts}", flush=True)

    # inject mode: one session batched with three others against its solo run
    eng_i = engine(inject=True)
    rng = np.random.RandomState(seed)
    banks = [{"init": rng.randn(SESSION_FRAMES + 6, 1, cfg.acoustic_vae_dim).astype(np.float32)}
             for _ in range(4)]
    his = [eng_i.submit(text, noise_bank=bk, max_new_frames=SESSION_FRAMES) for bk in banks]
    batched = [h.result(timeout=300) for h in his]
    alone = eng_i.submit(text, noise_bank=banks[0], max_new_frames=SESSION_FRAMES).result(300)
    eng_i.shutdown(drain=False)
    del eng_i
    calls = iter(range(10 ** 6))
    solo = st.generate(cfg, params, tts_text_ids=text[None], preset=preset, opts=opts,
                       max_len=STREAM_MAX_LEN, noise_bank=banks[0],
                       stop_check_fn=lambda: next(calls) >= SESSION_FRAMES // 6).speech_outputs[0]
    rel = lambda a, r: float(np.abs(a - r).max() / np.abs(r).max()) if a.shape == r.shape \
        else float("inf")
    err_alone, err, fault = rel(batched[0], alone), rel(batched[0], solo), rel(batched[1], solo)
    print(f"  inject mode: session 0 of 4 batched against itself alone in the engine: max |diff| "
          f"{err_alone:.3e} of the peak (tol {GRAPH_TOL:g}); against its solo generate() at "
          f"batch 1 (same bank): {err:.3e} (tol {SESSION_SOLO_TOL:g}); another session's audio "
          f"(another bank) reads {fault:.3e}", flush=True)
    if not (err_alone <= GRAPH_TOL and err <= SESSION_SOLO_TOL < fault):
        fail("session engine: a batched inject-mode session differs from its solo runs")
    return dict(engine=eng, params=params, runs=dict(
        warmup_s=warm_s, sessions=len(audio), audio_s=secs, wall_s=wall, rtf=secs / wall,
        stats=stats, launches=counts, inject_vs_alone_rel_err=err_alone,
        inject_vs_solo_rel_err=err, other_session_rel_diff=fault), launches=counts)


def http_end_to_end(engine, processor, rt_engine, rt_params) -> dict:
    """Phase 10: the HTTP server (serving/server.py build_server) in this
    process on port 0 over phase 8's and phase 9's engines: /health,
    /tts (two speakers, voices from demo/voices) as a whole WAV and as
    /tts/stream, /v1/audio/speech as wav and pcm (and a 400 for opus),
    /tts/rt plain and live (/append, /end), /stats. Phase 9 held EOS off;
    here the session engine's EOS bias, the tensor its graphs read, is set
    to +30 in place, so that every /tts/rt session ends: a plain one after
    its first frame, a live one parks there and speaks one more frame when
    /append resumes it. Status codes, WAV headers and PCM lengths must be
    right."""
    import http.client
    import struct
    import threading

    from vibevoice_tpu_torch.serving import server as srv

    rt_params["tts_eos_classifier"]["fc2"]["b"].fill_(30.0)
    httpd = srv.build_server(srv.parse_args(["--port", "0", "--request_timeout", "600"]),
                             engine=engine, processor=processor, rt_engine=rt_engine)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port, hop = httpd.server_address[1], engine._hop
    rt_hop = rt_engine.cfg.acoustic_tokenizer_config.hop_length
    rec = {}

    def call(method, path, payload=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
        conn.request(method, path, None if payload is None else json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return conn, r

    def read(method, path, payload=None, status=200):
        t = time.perf_counter()
        conn, r = call(method, path, payload)
        body = r.read()
        conn.close()
        if r.status != status:
            fail(f"HTTP {method} {path}: status {r.status}, not {status}: {body[:200]!r}")
        rec[f"{method} {path} {len(rec)}"] = dict(status=r.status, bytes=len(body),
                                                  seconds=time.perf_counter() - t)
        return r, body

    def whole_wav(path, body):
        n = struct.unpack("<I", body[40:44])[0] // 2
        if not (body[:4] == b"RIFF" and body[8:16] == b"WAVEfmt " and len(body) == 44 + 2 * n
                and struct.unpack("<I", body[4:8])[0] == 36 + 2 * n and n > 0 and n % hop == 0):
            fail(f"HTTP {path}: not a whole 16-bit WAV of whole frames ({len(body)} bytes)")
        return n

    def stream_wav(path, r, body, step):
        if not (r.getheader("Transfer-Encoding") == "chunked"
                and body[:44] == srv.STREAM_WAV_HEADER and (len(body) - 44) % (2 * step) == 0):
            fail(f"HTTP {path}: not a chunked live WAV of whole frames ({len(body)} bytes)")
        return (len(body) - 44) // (2 * step)

    _, body = read("GET", "/health")
    if json.loads(body)["status"] != "ok":
        fail(f"HTTP /health: {body!r}")
    two = {"text": "Speaker 1: Hello from the port's server.\nSpeaker 2: And hello back.",
           "speaker_names": ["Alice", "Carter"]}
    _, body = read("POST", "/tts", two)
    n = whole_wav("/tts", body)
    r, body = read("POST", "/tts/stream", two)
    if stream_wav("/tts/stream", r, body, hop) * hop != n:
        fail("HTTP /tts/stream: another frame count than /tts for the same request")
    one = {"model": "vibevoice", "input": "A single speaker, bare text.", "voice": "Frank"}
    r, body = read("POST", "/v1/audio/speech", one)
    n1 = whole_wav("/v1/audio/speech", body)
    r, pcm = read("POST", "/v1/audio/speech", {**one, "response_format": "pcm"})
    if r.getheader("Content-Type") != "audio/pcm" or len(pcm) != 2 * n1:
        fail(f"HTTP /v1/audio/speech pcm: {len(pcm)} bytes, not {2 * n1}")
    _, body = read("POST", "/v1/audio/speech", {**one, "response_format": "opus"}, status=400)
    if "opus" not in json.loads(body)["error"]["message"]:
        fail(f"HTTP /v1/audio/speech opus: {body!r}")
    r, body = read("POST", "/tts/rt", {"text": STREAM_SCRIPT})
    if stream_wav("/tts/rt", r, body, rt_hop) != 1:
        fail("HTTP /tts/rt: not the one frame before EOS")
    conn, r = call("POST", "/tts/rt", {"text": "Live text arrives", "live": True})
    sid = r.getheader("X-Session-Id")
    if r.status != 200 or not sid:
        fail(f"HTTP /tts/rt live: status {r.status}, session {sid!r}")
    box = {}
    reader = threading.Thread(target=lambda: box.update(wav=r.read()), daemon=True)
    reader.start()
    if not httpd.live_sessions[sid].parked.wait(300):
        fail("HTTP /tts/rt live: the session never parked")
    _, body = read("POST", "/tts/rt/append", {"session": sid, "text": "in three parts"})
    if json.loads(body)["appended_tokens"] != 3:
        fail(f"HTTP /tts/rt/append: {body!r}")
    read("POST", "/tts/rt/end", {"session": sid})
    reader.join(300)
    conn.close()
    if reader.is_alive() or stream_wav("/tts/rt live", r, box["wav"], rt_hop) != 2:
        fail("HTTP /tts/rt live: the stream did not end with its two frames")
    read("POST", "/tts/rt/append", {"session": sid, "text": "late"}, status=404)
    _, body = read("GET", "/stats")
    stats = json.loads(body)
    if stats["rt_sessions"]["parked"] != 0 or stats["failed"] != 0:
        fail(f"HTTP /stats: {stats}")
    httpd.shutdown()
    httpd.server_close()
    print(f"  HTTP on port {port}: /health, /tts ({n // hop} frames) and /tts/stream, "
          f"/v1/audio/speech wav ({n1 // hop} frames), pcm and 400 for opus, /tts/rt (1 frame), "
          f"live /tts/rt + /append + /end (2 frames), 404 after it, /stats: every status, header "
          f"and length right", flush=True)
    return dict(requests=rec, stats=stats)


# Phase 11: end to end from a checkpoint. The writer below is the inverse
# of vibevoice_tpu_torch/utils/torch_convert.py: it lays a dense port tree
# out as the reference's state dict (PyTorch modules' key paths, linear
# weights (out, in), convolutions as stored) and writes it as an HF-style
# directory of safetensors shards. The package has no exporter (nor has the
# JAX package); tests/test_torch_hf_interop.py holds this writer against the
# JAX package's converter, which must read every key it writes.
CKPT_SHARDS = 3


def reference_state_dict(params: dict, *, streaming: bool = False, prefix: str = "model.",
                         lower_norm: bool = True, upper_embed: bool = True) -> dict:
    """The reference state dict of a dense port tree (views; nothing is
    copied). Multi-speaker: ``{prefix}language_model``, the tokenizers,
    connectors and ``prediction_head`` under ``prefix``, ``lm_head`` beside
    it (an untied tree's). Streaming: ``{prefix}language_model`` (its final
    norm left out with ``lower_norm=False``, as the reference's Identity
    leaves it), ``{prefix}tts_language_model`` (its embedding left out with
    ``upper_embed=False``) and ``tts_eos_classifier`` without the prefix."""
    sd = {}

    def lin(key, p):
        sd[key + ".weight"] = p["w"].t()
        if "b" in p:
            sd[key + ".bias"] = p["b"]

    def conv(key, p):
        sd[key + ".weight"] = p["w"]
        if "b" in p:
            sd[key + ".bias"] = p["b"]

    def qwen2(pre, p, norm=True, embed=True):
        if embed:
            sd[pre + "embed_tokens.weight"] = p["embed"]
        for i, layer in enumerate(p["layers"]):
            lp = f"{pre}layers.{i}."
            sd[lp + "input_layernorm.weight"] = layer["input_norm"]["w"]
            for name in ("q", "k", "v", "o"):
                lin(f"{lp}self_attn.{name}_proj", layer["attn"][name])
            sd[lp + "post_attention_layernorm.weight"] = layer["post_norm"]["w"]
            for name in ("gate", "up", "down"):
                lin(f"{lp}mlp.{name}_proj", layer["mlp"][name])
        if norm:
            sd[pre + "norm.weight"] = p["final_norm"]["w"]

    def coder(pre, p):
        for i, c in enumerate(p.get("down", [])):
            conv(f"{pre}downsample_layers.{i}.0.conv.conv", c)
        for i, c in enumerate(p.get("up", [])):
            conv(f"{pre}upsample_layers.{i}.0." + ("conv.conv" if i == 0 else "convtr.convtr"), c)
        for i, stage in enumerate(p["stages"]):
            for j, blk in enumerate(stage):
                bp = f"{pre}stages.{i}.{j}."
                sd[bp + "norm.weight"] = blk["norm"]["w"]
                conv(bp + "mixer.conv.conv.conv", blk["mixer"])
                sd[bp + "ffn_norm.weight"] = blk["ffn_norm"]["w"]
                lin(bp + "ffn.linear1", blk["ffn"]["fc1"])
                lin(bp + "ffn.linear2", blk["ffn"]["fc2"])
                if "gamma" in blk:
                    sd[bp + "gamma"], sd[bp + "ffn_gamma"] = blk["gamma"], blk["ffn_gamma"]
        conv(pre + "head.conv.conv", p["head"])
        if "w" in p.get("final_norm", {}):
            sd[pre + "norm.weight"] = p["final_norm"]["w"]

    def tokenizer(pre, p):
        for part, sub in p.items():
            coder(f"{pre}{part}.", sub)

    def connector(pre, p):
        lin(pre + "fc1", p["fc1"])
        sd[pre + "norm.weight"] = p["norm"]["w"]
        lin(pre + "fc2", p["fc2"])

    def head(pre, p):
        for i, layer in enumerate(p["layers"]):
            lp = f"{pre}layers.{i}."
            sd[lp + "norm.weight"] = layer["norm"]["w"]
            lin(lp + "adaLN_modulation.1", layer["adaln"])
            for name in ("gate", "up", "down"):
                lin(f"{lp}ffn.{name}_proj", layer["ffn"][name])
        lin(pre + "noisy_images_proj", p["noisy_proj"])
        lin(pre + "cond_proj", p["cond_proj"])
        lin(pre + "t_embedder.mlp.0", p["t_embedder"]["fc1"])
        lin(pre + "t_embedder.mlp.2", p["t_embedder"]["fc2"])
        lin(pre + "final_layer.adaLN_modulation.1", p["final"]["adaln"])
        lin(pre + "final_layer.linear", p["final"]["linear"])

    if streaming:
        qwen2(prefix + "language_model.", params["language_model"], norm=lower_norm)
        qwen2(prefix + "tts_language_model.", params["tts_language_model"], embed=upper_embed)
        sd[prefix + "tts_input_types.weight"] = params["tts_input_types"]
        for name in ("fc1", "fc2"):
            lin(f"tts_eos_classifier.{name}", params["tts_eos_classifier"][name])
    else:
        qwen2(prefix + "language_model.", params["lm"])
        tokenizer(prefix + "semantic_tokenizer.", params["semantic_tokenizer"])
        connector(prefix + "semantic_connector.", params["semantic_connector"])
        if "lm_head" in params:
            sd["lm_head.weight"] = params["lm_head"]
    tokenizer(prefix + "acoustic_tokenizer.", params["acoustic_tokenizer"])
    connector(prefix + "acoustic_connector.", params["acoustic_connector"])
    head(prefix + "prediction_head.", params["diffusion_head"])
    for name in ("speech_scaling_factor", "speech_bias_factor"):
        sd[prefix + name] = params[name]
    return sd


def write_safetensors(path, tensors: dict) -> int:
    """Write ``tensors`` (on any device) as one safetensors file, one tensor
    at a time through the host; returns the file's bytes."""
    import torch

    from vibevoice_tpu_torch.utils.safetensors_io import DTYPES

    names = {dt: name for name, dt in DTYPES.items()}
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def write_checkpoint(path, sd: dict, config, shards: int = CKPT_SHARDS) -> int:
    """An HF-style checkpoint directory: ``sd`` in ``shards`` safetensors
    files of about equal bytes (in key order), model.safetensors.index.json,
    config.json (``config``: a config JSON file, or a dict) and a
    preprocessor_config.json. Returns the shards' bytes."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    sizes = [t.numel() * t.element_size() for t in sd.values()]
    total, groups, acc = sum(sizes), [dict() for _ in range(shards)], 0
    for (key, t), n in zip(sd.items(), sizes):
        groups[min(shards - 1, acc * shards // max(total, 1))][key] = t
        acc += n
    weight_map, written = {}, 0
    for i, group in enumerate(groups):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        written += write_safetensors(path / name, group)
        weight_map.update(dict.fromkeys(group, name))
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1))
    (path / "config.json").write_text(json.dumps(config, indent=1) if isinstance(config, dict)
                                      else Path(config).read_text())
    (path / "preprocessor_config.json").write_text(json.dumps(
        {"processor_class": "VibeVoiceProcessor", "speech_tok_compress_ratio": 3200,
         "db_normalize": True}, indent=1))
    return written


CKPT_ROOT = ROOT / "build" / "phase11"
CLI_TIMEOUT = 300  # s, each CLI subprocess: start, build or load the kernels, load, run
PHASE11_NAMES = ("int8_matmul", "int8_matmul_gemm", "flash_cached_attention",
                 "flash_cached_attention_prefill", "fused_head_ffn_stack", "fused_stage_step")


class PeakRss:
    """The process's resident set while the block runs, sampled every 5 ms
    from /proc/self/statm on a thread: ``before`` and ``peak``, bytes."""

    def __init__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self.now()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.sample, daemon=True)

    def now(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def sample(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self.now())

    def __enter__(self):
        self.before = self.peak = self.now()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.now())


def tree_leaves(tree, path=""):
    """(path, tensor or value) of every leaf; a packed stack (PackedStage)
    gives its arrays and its shape fields."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}/{i}")
    elif hasattr(tree, "arrays"):
        yield from tree_leaves(tree.arrays, f"{path}/arrays")
        for k in ("eps", "dim", "hidden", "n_blocks", "quantized"):
            yield f"{path}/{k}", getattr(tree, k)
    else:
        yield path, tree


def tree_mismatches(got, want, label: str) -> dict:
    """Leaves of `got` that differ from `want`: keys, dtypes, shapes, bits.
    The two scale scalars are the loader's dtype (every floating leaf is
    cast, as the JAX loader's _to_dtype casts it) where random weights keep
    them f32: theirs compare by value. Returns {"leaves", "scalars"}."""
    import torch

    g, w = dict(tree_leaves(got)), dict(tree_leaves(want))
    if sorted(g) != sorted(w):
        fail(f"{label}: keys differ: {sorted(set(g) ^ set(w))[:8]}")
    bad, scalars = [], {}
    for k, wv in w.items():
        gv = g[k]
        if not isinstance(wv, torch.Tensor):
            if gv != wv:
                bad.append(k)
        elif k.endswith("_factor"):
            scalars[k] = (str(gv.dtype), str(wv.dtype))
            if not (gv.shape == wv.shape == () and gv.float().item() == wv.float().item()):
                bad.append(k)
        elif not (gv.dtype == wv.dtype and gv.shape == wv.shape and torch.equal(
                gv.reshape(-1).view(torch.uint8), wv.reshape(-1).view(torch.uint8))):
            bad.append(k)
    if bad:
        fail(f"{label}: {len(bad)} of {len(w)} leaves differ from the reference, e.g. {bad[:6]}")
    print(f"  {label}: {len(w)} leaves bit-equal to the reference's, key by key (the two scale "
          f"scalars by value: loaded / reference dtype {sorted(set(scalars.values()))})",
          flush=True)
    return dict(leaves=len(w), scalars=scalars)


def run_cli(module: str, args: list, wav: Path, label: str) -> dict:
    """One CLI as a subprocess on the card: exit 0, its WAV written (a
    16-bit mono header and whole samples) and its RTF line printed."""
    import struct

    env = {**os.environ, "VIBEVOICE_ALLOW_FALLBACK_TOKENIZER": "1"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, "--device", "cuda", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"{label}: exit {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    rtf = [ln for ln in res.stdout.splitlines() if "RTF:" in ln]
    if not rtf:
        fail(f"{label}: no RTF line in\n{res.stdout[-2000:]}")
    body = wav.read_bytes() if wav.exists() else b""
    n = struct.unpack("<I", body[40:44])[0] // 2 if len(body) >= 44 else -1
    if not (body[:4] == b"RIFF" and body[8:16] == b"WAVEfmt " and len(body) == 44 + 2 * n
            and n > 0):
        fail(f"{label}: no whole 16-bit WAV with audio at {wav} ({len(body)} bytes)")
    lines = [ln for ln in res.stdout.splitlines() if ln and not ln.startswith("Generating")]
    print(f"  {label}: exit 0 in {wall:.1f} s (process start, kernels, load and run), "
          f"{n} samples ({n / 24_000:.2f} s) in its WAV; " + " | ".join(lines[-4:]), flush=True)
    return dict(wall_s=wall, samples=n, stdout_tail=lines[-6:])


def page_cache_bytes() -> int:
    """The host's page cache (/proc/meminfo's Cached), bytes."""
    with open("/proc/meminfo") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("Cached:"))


def drop_page_cache(path: Path):
    """Write back and evict the page cache's copy of every file in ``path``
    (fsync, then POSIX_FADV_DONTNEED), so that the next read comes from the
    disk. Returns how far the page cache shrank and the files' size, bytes:
    a file system whose cache lies outside this kernel (a 9p mount's host)
    ignores the advice, and the cache does not shrink."""
    before, size = page_cache_bytes(), 0
    for f in sorted(path.iterdir()):
        if f.is_file():
            size += f.stat().st_size
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
    return before - page_cache_bytes(), size


def load_cold_and_warm(path: Path, load, label: str):
    """Run ``load()``, a checkpoint load onto the card that returns a model
    with ``.load_walls``, twice: cold (the checkpoint's pages first dropped
    from the page cache, as a server starting on a checkpoint it has not
    read lately reads it; the print says whether the cache shrank by the
    checkpoint's size) and warm (just read, still cached). Prints and
    returns each load's wall, its phases' walls, the host's resident set
    before and at its peak, and the card memory it holds; returns the warm
    load's model."""
    import torch

    rec = {}
    for cache in ("cold", "warm"):
        dropped, size = drop_page_cache(path) if cache == "cold" else (0, 0)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        with PeakRss() as rss:
            t0 = time.perf_counter()
            model = load()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        card_bytes = torch.cuda.memory_allocated() - base_mem
        rec[cache] = dict(load_s=wall, walls=dict(model.load_walls), rss_before=rss.before,
                          rss_peak=rss.peak, card_bytes=card_bytes, cache_dropped=dropped)
        note = ""
        if cache == "cold":
            kept = "" if dropped >= 0.9 * size else (
                ": the file system kept its pages, so this read was not cold")
            note = (f" (the page cache shrank by {dropped / 2**30:.3f} GiB of the checkpoint's "
                    f"{size / 2**30:.3f}{kept})")
        print(f"  {label}, {cache} page cache{note}: {wall:.3f} s; walls "
              f"{', '.join(f'{k} {v:.3f} s' for k, v in model.load_walls.items())}; host RSS "
              f"{rss.before / 2**30:.2f} GiB before, peak {rss.peak / 2**30:.2f} GiB "
              f"(+{(rss.peak - rss.before) / 2**30:.2f}); the loaded tree "
              f"{card_bytes / 2**30:.3f} GiB on the card", flush=True)
        if cache == "cold":
            del model
            gc.collect()
            torch.cuda.empty_cache()
    return model, rec


def checkpoint_end_to_end(seed: int, frames: int, phase4_reference) -> dict:
    """Phase 11: end to end from checkpoints written here, under
    build/phase11 (removed at the end).

    1.5B: the dense bf16 weights VibeVoiceTTS.random starts from
    (utils.params.init at --seed) as a reference-layout checkpoint (three
    safetensors shards, model.safetensors.index.json, the port's 1.5B
    config.json, preprocessor_config.json, no tokenizer files: the
    processor refuses it unless VIBEVOICE_ALLOW_FALLBACK_TOKENIZER=1, which
    this phase then sets). VibeVoiceTTS.from_pretrained(int8=True) and the
    serving packs must give VibeVoiceTTS.random's tree bit for bit, key by
    key; phase 4's forced 32-frame generate() at 4096 (graphed, K = 4) on
    it must give phase 4's tokens and audio bits, launching kernels A (both
    routes), B (both routes), C and D. The checkpoint's bytes and, for a
    cold and a warm load (load_cold_and_warm), the load's walls (read: the
    shards mapped; transfer: their pages read and copied to the card;
    convert: layouts and dtype on the card; quantize; the serving packs),
    the host's resident set before and at its peak during the load and the
    card's memory after it are printed.

    0.5B: init_streaming at --seed with the EOS classifier's output bias at
    -30, written the same way (without the lower stack's final norm, as the
    reference stores it), and phase 6's voice preset as .npz;
    StreamingTTS.from_pretrained (cold, then warm) must give the dense tree
    bit for bit, and
    after fuse_vocoder(quantize=True) a 36-frame stream() must launch B and
    D, be finite, not silent, and equal the same stream of
    StreamingTTS.random's model (the same bits).

    Then both file CLIs run once as subprocesses (--device cuda --int8,
    bounded lengths): the streaming one on that checkpoint, the
    multi-speaker one on the 1.5B's weights made to speak
    (utils.params.speaking, c 64, with an untied lm_head: random weights
    pick eos or speech_start at the first frame and give no audio), each
    written the same way. Each must exit 0, write a WAV with audio and print
    its RTF line."""
    import itertools
    import shutil

    import numpy as np
    import torch

    from vibevoice_tpu_torch.configs import VibeVoiceConfig, VibeVoiceStreamingConfig
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import streaming as st
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor
    from vibevoice_tpu_torch.tts import StreamingTTS, VibeVoiceTTS
    from vibevoice_tpu_torch.utils.params import init, init_streaming, speaking

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    rec = {}
    try:
        # -- the 1.5B checkpoint
        path = CKPT_ROOT / "vibevoice-1.5b"
        t0 = time.perf_counter()
        dense = init(VibeVoiceConfig.from_json_file(str(CONFIG_1P5B)), seed=seed,
                     dtype=torch.bfloat16)
        nbytes = write_checkpoint(path, reference_state_dict(dense), CONFIG_1P5B)
        write_s = time.perf_counter() - t0
        del dense
        torch.cuda.empty_cache()
        print(f"  1.5B checkpoint: {nbytes} bytes in {CKPT_SHARDS} bf16 shards "
              f"({nbytes / 2**30:.3f} GiB), written in {write_s:.2f} s", flush=True)
        os.environ.pop("VIBEVOICE_ALLOW_FALLBACK_TOKENIZER", None)
        try:
            VibeVoiceProcessor.from_pretrained(str(path))
            fail("a checkpoint without tokenizer files loaded without the fallback variable")
        except RuntimeError as e:
            if "tokenizer" not in str(e):
                raise
        os.environ["VIBEVOICE_ALLOW_FALLBACK_TOKENIZER"] = "1"

        def load_1p5b():
            tts = VibeVoiceTTS.from_pretrained(str(path), int8=True)
            t0 = time.perf_counter()
            tts.params = vv.fuse_for_serving(tts.params, tts.cfg, quantize=True)
            torch.cuda.synchronize()
            tts.load_walls["serving_packs"] = time.perf_counter() - t0
            return tts

        tts, loads = load_cold_and_warm(
            path, load_1p5b, "1.5B VibeVoiceTTS.from_pretrained(int8=True) + serving packs")
        model = serving_model(seed)
        rec["vibevoice_1.5b"] = dict(
            checkpoint_bytes=nbytes, write_s=write_s, loads=loads,
            tree=tree_mismatches(tts.params, model["params"], "1.5B loaded tree"))

        # phase 4's forced run on the loaded weights
        cfg, toks = model["cfg"], model["toks"]
        proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
        forced, short = forced_scripts(toks, frames)
        opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096,
                                   frames_per_dispatch=4)

        def run(script):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inf.generate(cfg, tts.params, input_ids=proc.input_ids,
                               valid_mask=proc.attention_mask, speech_tensors=proc.speech_tensors,
                               speech_frame_valid=proc.speech_masks,
                               speech_input_mask=proc.speech_input_mask, tokens=toks, seed=seed,
                               opts=opts, forced_tokens=np.asarray(script, np.int64)[:, None])
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        run(short)  # captures the graph
        reset_counts(PHASE11_NAMES)
        out, wall = run(forced)
        counts = read_counts(PHASE11_NAMES)
        audio = out.speech_outputs[0]
        missing = [n for n, v in counts.items() if v == 0]
        if missing:
            fail(f"1.5B from a checkpoint: kernels never launched: {missing}")
        same_tokens = np.array_equal(out.sequences, phase4_reference[0])
        same_audio = audio is not None and np.array_equal(audio, phase4_reference[1])
        print(f"  1.5B from the checkpoint, phase 4's forced {len(forced)}-frame generate() at "
              f"4096 (graphed, K = 4): wall {wall:.3f} s, tokens "
              f"{'equal' if same_tokens else 'DIFFER'}, audio bits "
              f"{'equal' if same_audio else 'DIFFER'} to phase 4's, launches {counts}",
              flush=True)
        if not (same_tokens and same_audio):
            fail("1.5B from a checkpoint: generate() differs from phase 4's")
        rec["vibevoice_1.5b"].update(generate_wall_s=wall, launches=counts)
        launches = dict(counts)
        # for the CLI: the same weights made to speak (utils.params.speaking
        # at the checkpoint processor's special ids; greedy decoding then
        # diffuses every frame), whose lm_head is then untied
        blob = json.loads(CONFIG_1P5B.read_text())
        blob["decoder_config"]["tie_word_embeddings"] = False
        speak_path = CKPT_ROOT / "vibevoice-1.5b-speaking"
        t0 = time.perf_counter()
        dense = speaking(init(VibeVoiceConfig.from_dict(blob), seed=seed, dtype=torch.bfloat16),
                         tts.tokens, c=64.0)
        speak_bytes = write_checkpoint(speak_path, reference_state_dict(dense), blob)
        print(f"  the speaking 1.5B checkpoint for the CLI: {speak_bytes} bytes in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del tts, model, out, dense
        inf._captures.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # -- the 0.5B checkpoint and phase 6's preset
        rt_path = CKPT_ROOT / "vibevoice-0.5b-streaming"
        scfg = VibeVoiceStreamingConfig.from_json_file(str(CONFIG_0P5B))
        t0 = time.perf_counter()
        sdense = with_eos_bias(init_streaming(scfg, seed=seed, dtype=torch.bfloat16), -30.0)
        snbytes = write_checkpoint(rt_path, reference_state_dict(sdense, streaming=True,
                                                                 lower_norm=False), CONFIG_0P5B)
        swrite_s = time.perf_counter() - t0
        smodel = streaming_model(seed)
        voice = CKPT_ROOT / "voice.npz"
        smodel["preset"].save(str(voice))
        print(f"  0.5B checkpoint: {snbytes} bytes ({snbytes / 2**30:.3f} GiB) written in "
              f"{swrite_s:.2f} s", flush=True)
        rt, sloads = load_cold_and_warm(
            rt_path, lambda: StreamingTTS.from_pretrained(str(rt_path), voice=str(voice),
                                                          max_len=STREAM_MAX_LEN),
            "0.5B StreamingTTS.from_pretrained")
        stree = tree_mismatches(rt.params, sdense, "0.5B loaded tree")
        del sdense
        rt.params = st.fuse_vocoder(rt.params, rt.cfg, quantize=True)
        # the same processor (the checkpoint's fallback tokenizer), so the same text ids
        ref = StreamingTTS(smodel["cfg"], with_eos_bias(smodel["params"], -30.0), rt.processor,
                           smodel["preset"], max_len=STREAM_MAX_LEN)
        names = ("flash_cached_attention", "flash_cached_attention_prefill", "fused_stage_step")

        def stream(t):
            calls = itertools.count()
            reset_counts(names)
            chunks = list(t.stream(STREAM_SCRIPT, seed=seed,
                                   stop_check_fn=lambda: next(calls) >= STREAM_WINDOWS))
            return (np.concatenate(chunks) if chunks else np.zeros(0, np.float32)), \
                read_counts(names)

        rt.warmup()
        saudio, scounts = stream(rt)
        ref.warmup()
        raudio = stream(ref)[0]
        hop = scfg.acoustic_tokenizer_config.hop_length
        sframes = STREAM_WINDOWS * 6
        missing = [n for n, v in scounts.items() if v == 0]
        print(f"  0.5B from the checkpoint: stream() of {saudio.size // hop} frames, peak "
              f"{float(np.abs(saudio).max()) if saudio.size else 0.0:.3e}, "
              f"{'equal' if np.array_equal(saudio, raudio) else 'NOT equal'} to "
              f"StreamingTTS.random's stream, launches {scounts}", flush=True)
        if missing or saudio.size != sframes * hop or not np.isfinite(saudio).all() \
                or not np.abs(saudio).max() > 0:
            fail(f"0.5B from a checkpoint: {saudio.size} samples, launches {scounts}")
        if not np.array_equal(saudio, raudio):
            fail("0.5B from a checkpoint: the stream differs from StreamingTTS.random's")
        for n, v in scounts.items():
            launches[n] += v
        rec["vibevoice_0.5b"] = dict(checkpoint_bytes=snbytes, write_s=swrite_s, loads=sloads,
                                     tree=stree, launches=scounts)
        del rt, ref, smodel
        inf._captures.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # -- the two CLIs
        out_dir = CKPT_ROOT / "out"
        rec["cli"] = run_cli("vibevoice_tpu_torch.demo.inference_from_file",
                             ["--model_path", str(speak_path), "--int8", "--output_dir",
                              str(out_dir), "--max_length", "96"],
                             out_dir / "generated_0.wav", "inference_from_file (1.5B)")
        rec["streaming_cli"] = run_cli(
            "vibevoice_tpu_torch.demo.streaming_inference_from_file",
            ["--model_path", str(rt_path), "--voice_preset", str(voice), "--int8",
             "--max_len", str(STREAM_PRESET + 11 * STREAM_WINDOWS),
             "--output_path", str(out_dir / "streaming.wav"), "--text", STREAM_SCRIPT],
            out_dir / "streaming.wav", "streaming_inference_from_file (0.5B)")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    return dict(runs=rec, launches=launches)


# Phase 12: the 7B (vibevoice_tpu_torch/configs/qwen2.5_7b_32k.json) at full
# width on one card: hidden 3584, 28 query heads over 4 KV heads of 128 (G
# 7), FFN 18944, an untied lm_head of 152,064 columns, a 3584-10752-3584
# diffusion head, 32,768 positions; the tokenizers, so kernel D, are the
# 1.5B's. Its kernels' entries in the kernels line are "<kernel>@7b".
LM_SHAPES_7B = (("q/o", 3584, 3584), ("k/v", 3584, 512), ("gate/up", 3584, 18944),
                ("down", 18944, 3584))  # (name, IN, OUT) of the 7B decoder's int8 linears
LM_HEAD_7B = ("lm_head", 3584, 152064)  # its untied int8 lm_head (kernel A's GEMV at decode)
HEADS_7B = (28, 4, 128)
# The long-form run: a 16,384-token prompt into a 32,768-slot int8 cache
# (the config's max_position_embeddings; int8 from KV_INT8_AUTO_LEN), then
# 32 graphed frames at that fill.
LONG_7B = 16384
# utils.params.speaking's constant for the 7B's random weights: the 1.5B
# needs 64 (phase 8); the 7B's wider random layers grow the residual stream
# that the final norm divides by, so its hidden unit is held twice as high.
SPEAK_C_7B = 128.0
CKPT_7B_LAYERS = 4  # the 7B checkpoint at full width, cut to 4 layers (~7.4 GB in bf16)
# the trainer's run: QLoRA, B 1, T 2048, 3 steps
FINETUNE_RUNS_7B = (("B1 T2048", ["--per_device_batch_size", "1", "--max_length", "2048",
                                  "--pad_to_multiple", "2048", "--synthetic_seconds", "220",
                                  "250", "--max_steps", "3"]),)


def check_7b_kernels(checks: Checks, seed: int) -> None:
    """Phase 12 (a): every kernel at the 7B's shapes against its plain
    version (the tolerances of phase 3), timed with its bound and library
    call, and replayed from a CUDA graph against its eager call (the same
    bits): A's GEMV at 2 and 8 rows over the four LM shapes and the lm_head
    (the 2-row call also replayed on new x against the plain version), B's
    decode at 4,096 bf16 slots (also replayed at three other bases) and at
    32,768 int8 slots, B's prefill route on the long-form run's last chunk
    (2,048 rows from base 14,336 of 32,768, int8 and bf16), C at 4 layers
    3584-10752-3584 (2 rows f32; int8 and bf16 weights), D at its 1.5B
    shapes (1 row, int8), F over a world of one's 16,384-token prompt with
    A's GEMM at those 16,384 rows, E at B1 T2048's 2,048 f32 rows, and the
    training attention forward and backward at B1 T2048."""
    import torch

    from vibevoice_tpu_torch.ops import head_fused as hf
    from vibevoice_tpu_torch.ops import quant
    from vibevoice_tpu_torch.ops import vocoder_fused as vf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 12)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device=dev).to(dt)

    print("kernel A int8_matmul at the 7B's decode shapes (bf16 x, int8 w, f32 scale; tol 1e-2; "
          "library: torch.mm on a bf16 copy of the weight)")
    for name, k, n in LM_SHAPES_7B + (LM_HEAD_7B,):
        ws = rotating(lambda: quant.quantize_weight(randn(k, n, dt=torch.float32) * 0.02), k * n)
        for rows in (2, 8):
            x = randn(rows, k)
            label = f"{name} {k}x{n} rows={rows}"
            check_int8_matmul(checks, label, x, ws, 1e-2, main=(name == "gate/up" and rows == 2))
            if rows == 2:
                gemv_graph_check(checks, label, x, ws[0])
            graph_vs_eager(checks, "int8_matmul", label,
                           lambda: quant.int8_matmul(x, ws[0]["w8"], ws[0]["scale"]), (x,))
        del ws

    print("kernel B flash_cached_attention at the 7B's layout (28 q heads, 4 KV heads, head_dim "
          "128; bf16 q; tol 1e-2; library as above)")
    for w, s_, int8, base, main in ((1, 4096, False, (4095, 1234), True),
                                    (1, 32768, True, (32767, LONG_7B + 32), False),
                                    (2048, 32768, True, (LONG_7B - 2048,), True),
                                    (2048, 32768, False, (LONG_7B - 2048,), False)):
        check_cached_attention(checks, g, HEADS_7B, w, s_, int8, base, main=main,
                               graph_bases=((0, 4095), SERVING_FILL, (3000, 17))
                               if (w, int8) == (1, False) else None, graph_bits=True)
        torch.cuda.empty_cache()

    dim, hid, nl = 3584, 10752, 4
    print(f"kernel C fused_head_ffn_stack at the 7B's head ({nl} layers {dim}-{hid}-{dim}; f32 x "
          f"and mods, 2 rows; int8 or bf16 weights: tol 1e-4)")
    for quantize in (True, False):
        layers = head_layers(randn, dim, hid, nl)
        packs = [hf.pack_head_ffns(layers, 1e-5, quantize)]  # 0.46 / 0.92 GB: no copy needed
        del layers
        x = randn(2, dim, dt=torch.float32)
        mods = randn(nl, 2, 3 * dim, dt=torch.float32) * 0.5
        label = f"{nl} layers {dim}-{hid} {'int8' if quantize else 'bf16'} weights"
        call = lambda: hf.fused_head_ffn_stack(packs[0], x, mods)
        out = call()
        ms = bench_ms(lambda pk: hf.fused_head_ffn_stack(pk, x, mods), packs)
        pms = bench_ms(lambda pk: hf.fused_head_ffn_stack_plain(pk, x, mods), packs)
        checks.case("fused_head_ffn_stack", label, out,
                    hf.fused_head_ffn_stack_plain(packs[0], x, mods), 1e-4, ms, pms, main=quantize,
                    bound=bound(2 * 2 * 3 * dim * hid * nl,
                                nbytes(*packs[0].arrays.values(), x, mods, out), "f32"))
        fused_call_checks(checks, "fused_head_ffn_stack", label, call,
                          lambda: hf.fused_head_ffn_stack_plain(packs[0], x, mods), (x, mods), 1e-4)
        graph_vs_eager(checks, "fused_head_ffn_stack", label, call, (x, mods))
        del packs

    dim, nb = 2048, 8
    print("kernel D fused_stage_step on the 7B's path (its tokenizers are the 1.5B's: 8 blocks "
          "2048-8192-2048, 1 row bf16, int8 weights: tol 2e-2)")
    blocks = stage_blocks(randn, dim, nb)
    packs = rotating(lambda: vf.pack_stage(blocks, 1e-5, True), nb * 8 * dim * dim,
                     budget=120 << 20)
    x, st = randn(1, 1, dim), randn(nb, 1, 6, dim)
    call = lambda: vf.fused_stage_step(packs[0], x, st)
    (out, ns), (ref, rs) = call(), vf.fused_stage_step_plain(packs[0], x, st)
    ms = bench_ms(lambda pk: vf.fused_stage_step(pk, x, st), packs)
    pms = bench_ms(lambda pk: vf.fused_stage_step_plain(pk, x, st), packs)
    label = f"{nb} blocks int8 weights"
    checks.case("fused_stage_step", f"{label}: y", out, ref, 2e-2, ms, pms, main=True,
                bound=bound(2 * nb * (8 * dim * dim + 7 * dim),
                            nbytes(*packs[0].arrays.values(), x, st, out, ns)))
    checks.case("fused_stage_step", f"{label}: new state", ns, rs, 2e-2)
    fused_call_checks(checks, "fused_stage_step", label, call,
                      lambda: vf.fused_stage_step_plain(packs[0], x, st), (x, st), 2e-2)
    graph_vs_eager(checks, "fused_stage_step", label, call, (x, st))
    del packs, blocks
    torch.cuda.empty_cache()

    check_ring_kernel(checks, seed + 12, heads=HEADS_7B, k_lens=(LONG_7B,), lm_shapes=LM_SHAPES_7B,
                      four_ring=False, graphs=True)
    torch.cuda.empty_cache()
    # A's GEMM on f32 training rows is held to E's tolerance (1e-4), the
    # phase's bound for the same arithmetic (bf16 operands, f32 sums on the
    # tensor cores, f32 out) over the 7B's reductions: the tensor cores'
    # f32 accumulation drifts from the plain version's FFMA sums with K (on
    # an H100, --seed 0: 2.8e-6 of the peak at K 3,584, 1.9e-5 at down's
    # 18,944), past the 1e-5 that the 1.5B's K of at most 8,960 keeps (its
    # down reads 6.2e-6).
    check_training_kernels(checks, seed + 12, heads=HEADS_7B, e_cases=((2048, LM_SHAPES_7B),),
                           attn_cases=((1, 2048, (1900,)),), graphs=True, a_f32_tol=1e-4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serving_engine_7b(model: dict, seed: int) -> dict:
    """Phase 12 (d): ServingEngine(max_batch=4, max_len=4096,
    frames_per_dispatch=4) over the 7B made to speak (utils.params.speaking,
    SPEAK_C_7B), after warmup(): eight requests of the two-speaker prompt,
    ENGINE_FRAMES frames each, submitted at once (staged as phase 8 stages
    its burst, so that four decode together): each completes with its
    frames of audio; audio seconds a wall second, TTFA p50/p95 and a
    replayed window's device time a frame are printed; the request that ran
    in slot 3 is run again alone in the same engine on the noise rows its
    slot was given and must give the same audio (GRAPH_TOL)."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.engine import Request, ServingEngine
    from vibevoice_tpu_torch.utils.params import speaking

    cfg, toks, hop, sr = (model[k] for k in ("cfg", "toks", "hop", "sr"))
    params = speaking(model["params"], toks, c=SPEAK_C_7B)
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    n = int(proc.attention_mask.sum())
    k = 4
    eng = ServingEngine(cfg, params, tokens=toks, frames_per_dispatch=k, max_batch=ENGINE_BATCH,
                        max_len=4096,
                        opts=inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096))
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0

    def request(s):
        return Request(input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                       speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                       speech_input_mask=proc.speech_input_mask, seed=s,
                       max_length_times=(ENGINE_FRAMES + 0.5) / n)

    rows, draw = record_noise_rows(eng)
    reset_counts(ENGINE_NAMES)
    t0 = time.perf_counter()
    with eng.step_fn.request():  # staged until two prefills wait, as phase 8's burst
        handles = [eng.submit(request(s)) for s in range(8)]
        if not eng.wait_for_state(eng.ready.full, 300):
            fail("7B serving engine: the burst's prefills were not staged in 300 s")
    audio = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t0
    counts = read_counts(ENGINE_NAMES)
    for s, (h, a) in enumerate(zip(handles, audio)):
        if h.rec["outcome"] != "completed" or a.size != ENGINE_FRAMES * hop \
                or not np.isfinite(a).all() or not np.abs(a).max() > 0:
            fail(f"7B serving engine: request {s} ended {h.rec['outcome']} with {a.size} samples "
                 f"(not {ENGINE_FRAMES} frames of {hop}), or not finite, or silent; its tokens "
                 f"{h.tokens[:8]}")
    missing = [name for name, v in counts.items() if v == 0]
    if missing:
        fail(f"7B serving engine: kernels never launched: {missing}")
    st = eng.stats()
    secs = sum(a.size for a in audio) / sr
    slots = {h: {slot for _, slot, _ in rows.get(h, [])} for h in handles}
    h3 = next((h for h in handles if 3 in slots[h]), None)
    if h3 is None:
        fail(f"7B serving engine: no request ran in slot 3 (slots {list(slots.values())})")
    got = audio[handles.index(h3)]
    alone = run_alone_on_rows(eng, request(h3.request.seed), rows[h3], draw)
    err = float(np.abs(alone - got).max() / np.abs(got).max()) \
        if alone.shape == got.shape else float("inf")
    times = []
    noise = inf._tree_map(lambda t: t.clone(), draw())
    ext = torch.zeros(k, ENGINE_BATCH, dtype=torch.bool, device="cuda")
    for _ in range(3):  # one replayed window of the 4 slots, its device time a frame
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        eng.step_fn(params, eng.carry, noise, ext)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]) / k)
    eng.carry.finished.fill_(True)
    eng.shutdown()
    print(f"  7B engine, max_batch {ENGINE_BATCH}, 4096 slots, K {k} (warmup {warm_s:.3f} s): 8 "
          f"requests of {ENGINE_FRAMES} frames at once in {wall:.3f} s, {secs / wall:.2f} audio s "
          f"a wall s; TTFA p50 {st.ttfa_p50_ms:.1f} ms, p95 {st.ttfa_p95_ms:.1f} ms; a replayed "
          f"window {sorted(times)[1]:.3f} ms a frame of device time; request "
          f"{handles.index(h3)} (slot 3) alone in the engine on its rows: max |diff| {err:.3e} of "
          f"the peak (tol {GRAPH_TOL:g}); launches {counts}", flush=True)
    if not err <= GRAPH_TOL:
        fail("7B serving engine: the slot-3 request differs from itself alone in the engine")
    return dict(runs=dict(warmup_s=warm_s, wall_s=wall, audio_s=secs, rtf=secs / wall,
                          ttfa_p50_ms=st.ttfa_p50_ms, ttfa_p95_ms=st.ttfa_p95_ms,
                          window_device_ms_per_frame=sorted(times), alone_in_engine_rel_err=err),
                launches=counts)


def checkpoint_7b_end_to_end(seed: int) -> dict:
    """Phase 12 (f): the 7B's random bf16 weights at full width, cut to
    CKPT_7B_LAYERS layers, written as a reference-layout checkpoint with an
    untied lm_head.weight (152,064 x 3584) under build/phase12, loaded cold
    and warm by VibeVoiceTTS.from_pretrained(int8=True) with the serving
    packs: the tree must be VibeVoiceTTS.random's on the same config, bit for
    bit, key by key. The files are removed at the end."""
    import shutil

    import torch

    from vibevoice_tpu_torch.configs import VibeVoiceConfig
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.tts import VibeVoiceTTS
    from vibevoice_tpu_torch.utils.params import init

    root = ROOT / "build" / "phase12"
    shutil.rmtree(root, ignore_errors=True)
    path = root / f"vibevoice-7b-{CKPT_7B_LAYERS}-layers"
    blob = json.loads(CONFIG_7B.read_text())
    blob["decoder_config"]["num_hidden_layers"] = CKPT_7B_LAYERS
    try:
        t0 = time.perf_counter()
        dense = init(VibeVoiceConfig.from_dict(blob), seed=seed, dtype=torch.bfloat16)
        sd = reference_state_dict(dense)
        head = sd.get("lm_head.weight")
        if head is None or tuple(head.shape) != (152064, 3584):
            fail(f"7B checkpoint: no untied lm_head.weight of (152064, 3584) in the state dict")
        nbytes_ = write_checkpoint(path, sd, blob)
        write_s = time.perf_counter() - t0
        del dense, sd, head
        torch.cuda.empty_cache()
        print(f"  7B checkpoint ({CKPT_7B_LAYERS} layers, untied lm_head): {nbytes_} bytes in "
              f"{CKPT_SHARDS} bf16 shards ({nbytes_ / 2**30:.3f} GiB), written in {write_s:.2f} s",
              flush=True)
        os.environ["VIBEVOICE_ALLOW_FALLBACK_TOKENIZER"] = "1"

        def load():
            tts = VibeVoiceTTS.from_pretrained(str(path), int8=True)
            t = time.perf_counter()
            tts.params = vv.fuse_for_serving(tts.params, tts.cfg, quantize=True)
            torch.cuda.synchronize()
            tts.load_walls["serving_packs"] = time.perf_counter() - t
            return tts

        tts, loads = load_cold_and_warm(
            path, load, f"7B ({CKPT_7B_LAYERS} layers) VibeVoiceTTS.from_pretrained(int8=True) + "
                        "serving packs")
        ref = VibeVoiceTTS.random(str(path / "config.json"), seed=seed)
        if "lm_head_q" not in tts.params or "lm_head" in tts.params:
            fail("7B checkpoint: the loaded tree has no int8 untied lm_head (lm_head_q)")
        tree = tree_mismatches(tts.params, ref.params, f"7B ({CKPT_7B_LAYERS} layers) loaded tree")
        del tts, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(checkpoint_bytes=nbytes_, write_s=write_s, loads=loads, tree=tree)


def the_7b(checks: Checks, seed: int, frames: int) -> dict:
    """Phase 12: the 7B on one card. (a) its kernels (check_7b_kernels);
    (b) serving at bs1: tts.VibeVoiceTTS.random on the 7B JSON (int8 LM and
    lm_head_q, fuse_for_serving(quantize=True)), phase 4's forced
    `frames`-frame script at 4,096 bf16 slots, graphed (K = 4) against eager:
    the same tokens, audio within GRAPH_TOL, equal launches; then the profile
    of one replayed 17-frame window; (c) long-form: a LONG_7B-token prompt
    by inference.chunked_prefill and by the world-of-one ring prefill into a
    32,768-slot int8 cache (held together within SP_TOL), then 32 graphed
    frames at that fill; (d) the serving engine (serving_engine_7b); (e)
    QLoRA: the trainer at --config <7B> --use_lora --int8_base, B1 T2048, 3
    steps; (f) a checkpoint (checkpoint_7b_end_to_end); (g) the 7B packed
    with an int8 head (surface_7b, for phase 14's "@pack@7b" and
    "@head@7b" entries). Every kernel's "@7b" entry must launch on these
    paths."""
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    t0 = time.perf_counter()
    walls, runs = {}, {}

    def add(launches):
        for name, v in launches.items():
            checks.kernels[name + "@7b"]["launches"] += v

    checks.tag = "@7b"
    try:
        check_7b_kernels(checks, seed)
    finally:
        checks.tag = ""
    walls["kernels"] = time.perf_counter() - t0

    t = time.perf_counter()
    model = serving_model(seed, CONFIG_7B)
    serving = end_to_end(model, seed, frames, lengths=(4096,), ks=(4,))
    add(serving["launches"])
    runs["serving"] = serving["runs"]
    runs["graphed_profile"] = graphed_profile(model, seed)
    walls["serving"] = time.perf_counter() - t
    t = time.perf_counter()
    runs["surface"] = surface_7b(model, seed)
    for name in ("int8_matmul@pack@7b", "int8_matmul@head@7b"):
        checks.kernels[name]["launches"] += runs["surface"]["launches"]["int8_matmul"]
    walls["surface"] = time.perf_counter() - t
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    long_form = sp_prefill_end_to_end(model, seed, frames=32, lengths=(LONG_7B,),
                                      cases=((32768, True, SP_TOL["int8"]),))
    add(long_form["launches"])
    runs["long_form"] = long_form["runs"]
    walls["long_form"] = time.perf_counter() - t
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    engine = serving_engine_7b(model, seed)
    add(engine["launches"])
    runs["serving_engine"] = engine["runs"]
    walls["serving_engine"] = time.perf_counter() - t
    del model
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    runs["finetune"] = finetune_end_to_end(seed, CONFIG_7B, FINETUNE_RUNS_7B)
    for rec in runs["finetune"].values():
        add(rec["launches"])
    walls["finetune"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    runs["checkpoint"] = checkpoint_7b_end_to_end(seed)
    walls["checkpoint"] = time.perf_counter() - t
    walls["phase"] = time.perf_counter() - t0

    graphed = runs["serving"]["max_length=4096 K=4 graphed"]
    eager = runs["serving"]["max_length=4096 K=4 eager"]
    prof = runs["graphed_profile"]
    lf = next(iter(runs["long_form"].values()))
    ft = next(iter(runs["finetune"].values()))
    ld = runs["checkpoint"]["loads"]
    eng = runs["serving_engine"]
    print(f"  the 7B: {graphed['per_frame_ms']:.2f} ms a frame graphed, "
          f"{eager['per_frame_ms']:.2f} eager (bs1, 4096 slots); one replayed "
          f"{prof['frames']}-frame window {prof['replay_ms']:.3f} ms of device time "
          f"({prof['replay_ms'] / prof['frames']:.3f} a frame); {LONG_7B}-token prefill: chunked "
          f"{lf['chunked_prefill_wall_s']:.3f} s, ring {lf['prefill_wall_s']:.3f} s; engine "
          f"{eng['rtf']:.2f} audio s a wall s, TTFA p50 {eng['ttfa_p50_ms']:.1f} ms; QLoRA "
          f"{ft['seconds_per_step']:.3f} s/step, peak {ft['peak_gib']:.2f} GiB; checkpoint load "
          f"cold {ld['cold']['load_s']:.3f} s, warm {ld['warm']['load_s']:.3f} s; walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)
    return dict(runs=runs, walls=walls)


# ---------------------------------------------------------------------------
# Phase 13: tensor parallelism (the rest of parallel/) on one card
# ---------------------------------------------------------------------------

# Kernel B's local heads under TP: the 7B's 28/4 over tp 2 and 4; the
# training attention's at the 1.5B's 12/2 over tp 2.
HEADS_7B_TP = {2: (14, 2, 128), 4: (7, 1, 128)}
HEADS_1P5B_TP2 = (6, 1, 128)
TP_ENGINE_FRAMES = 40
TP_ENGINE_BATCH = 4
CONFIG_HOP = 3200  # the acoustic tokenizer's hop (samples a frame) of every config here
TP_NAMES = ("flash_cached_attention", "flash_cached_attention_prefill", "fused_head_ffn_stack",
            "fused_stage_step")
# Limits of the two-rank (gloo, tp 2) run against the world of one (NCCL,
# tp 1) on the full-width 7B: max |diff| over the peak of h_pos after the
# prefill and of the valid cache of layers 0 and 27, by KV type. The two
# split the o and down sums in two and add the halves in f32 before one
# rounding to bf16 (tp 1 rounds the whole sum), so 28 layers drift apart
# as the ring prefill does (SP_TOL). On an H100 with --seed 0 (the same
# reading in two processes): h_pos 1.29e-2 / 1.21e-2, layer 0 0.0, layer 27
# 2.75e-2 / 3.20e-2 (bf16 / int8 KV). The limit is about three times the
# largest; the planted faults read 0.53 and above (h_pos), layer 27 1.08
# and above (the KV-head swap reads 1.44 at layer 0, the two others 0.0
# there: layer 0's cache is written before any all-reduce). The audio is
# printed, not held: the random-weight diffusion head and vocoder amplify
# the hidden states' drift (1.3e-2 at h_pos) to 0.41-0.53 of the peak in
# the first window and 1.05-1.14 over 32 frames (each frame's audio is
# encoded into the next frame's input), against 0.78-1.06 in the first
# window with a fault: no limit separates the two. The tokens are held
# equal instead.
TP_TOL = {"bf16": 1e-1, "int8": 1e-1}
# The decode step under TP is held on a text script: TP_TEXT_WINDOWS
# windows of K = 4 frames forced to the plain token TP_TEXT_TOKEN, whose
# next input is its embedding, the same on both runs (a speech frame's next
# input is its audio re-encoded, which the diffusion head amplifies as
# above). Read after the last window: h_pos, and the cache rows the windows
# wrote at positions n..n+4*windows of layers 0 and 27 (every KV head), as
# max |diff| over the peak against tp 1 (graphed). On an H100 with --seed 0:
# h_pos 1.29e-2, layer 0 0.0, layer 27 2.64e-2; the limit is about four
# times the largest. The all-reduce skipped in the decode step only reads
# 0.35 (h_pos) and 0.75 (layer 27) there, and as without a fault after the
# prefill; the three other faults 0.48 and above.
TP_TEXT_TOKEN = 1000
TP_TEXT_WINDOWS = 2
TP_STEP_TOL = 1e-1
# a planted fault must read at least this many times the limit
TP_FAULT_FACTOR = 3.0
TP_TRAIN_COMMON = ["--synthetic_data", "--synthetic_items", "4", "--synthetic_seconds", "100",
                   "115", "--use_lora", "--device", "cuda", "--max_length", "1024",
                   "--pad_to_multiple", "1024", "--max_steps", "3", "--log_steps", "1",
                   "--warmup_steps", "0"]  # step 1 updates the adapters
TP_TRAIN_TOL = 1e-4  # step 1's loss on a mesh against one rank, relative
# After the updates: the losses of steps 2-3, relative, and by the worst
# adapter leaf |mesh - one rank| / |one rank's change over the three steps|
# (norms). On an H100 with --seed 0: losses 2.2e-7 (tp 2) and 0.0 (dp 2),
# the adapters 3.3e-3 / 3.5e-3 (the updates took the loss from 13.97 to
# 12.55); the limits are three to five times the largest.
TP_TRAIN_STEP_TOL = 1e-6
TP_TRAIN_ADAPTER_TOL = 1e-2


def check_tp_kernels(checks: Checks, seed: int) -> None:
    """Phase 13 (a): kernel B at the local heads of tensor-parallel ranks of
    the 7B (14/2 at tp 2, 7/1 at tp 4; decode over 4,096 bf16 and 32,768
    int8 slots, and the prefill route on a 2,048-row chunk from base 14,336
    of 32,768, bf16 and int8), the training attention forward and backward
    at the 1.5B's tp 2 heads (6/1), B2 T2048, each against its plain version
    (phase 3's tolerances), timed with its bound and SDPA's time, and
    replayed from a CUDA graph against its eager call (the same bits)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 13)
    print("kernel B flash_cached_attention at tensor-parallel local heads of the 7B (head_dim "
          "128; bf16 q; tol 1e-2; library: SDPA with the prefix mask and enable_gqa)")
    for tp, w, s_, int8, base, main in ((2, 1, 4096, False, (4095, 1234), True),
                                        (2, 1, 32768, True, (32767, LONG_7B + 32), False),
                                        (4, 1, 4096, False, (4095, 1234), False),
                                        (4, 1, 32768, True, (32767, LONG_7B + 32), False),
                                        (2, 2048, 32768, False, (LONG_7B - 2048,), True),
                                        (2, 2048, 32768, True, (LONG_7B - 2048,), False)):
        heads = HEADS_7B_TP[tp]
        check_cached_attention(checks, g, heads, w, s_, int8, base, main=main,
                               label=f"tp {tp} {heads[0]}/{heads[1]} ", graph_bits=True)
        torch.cuda.empty_cache()
    check_training_kernels(checks, seed + 13, heads=HEADS_1P5B_TP2, e_cases=(),
                           attn_cases=((2, 2048, (2048, 1500)),), graphs=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def tp_model(seed: int, device: str = "cuda") -> dict:
    """The 7B at full width for tensor-parallel serving: random bf16 weights
    from the seed with a dense LM (tts.VibeVoiceTTS.random(int8_lm=False)),
    the serving packs of kernels C and D (fuse_for_serving(quantize=True)),
    made to speak (utils.params.speaking, SPEAK_C_7B), with phase 4's
    voices and script."""
    import numpy as np

    from vibevoice_tpu_torch.tts import VibeVoiceTTS
    from vibevoice_tpu_torch.utils.params import speaking

    tts = VibeVoiceTTS.random(str(CONFIG_7B), seed=seed, device=device, int8_lm=False)
    sr = 24_000
    t = np.arange(int(VOICE_SECONDS * sr)) / sr
    rng = np.random.RandomState(seed)
    voices = [(0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.randn(t.size)).astype(np.float32)
              for f in (180.0, 260.0)]
    script = ("Speaker 1: Welcome back to the show, today we talk about speech synthesis.\n"
              "Speaker 2: Thanks for having me, it is a pleasure to be here.")
    return dict(cfg=tts.cfg, params=speaking(tts.params, tts.tokens, c=SPEAK_C_7B),
                processor=tts.processor, toks=tts.tokens, voices=voices, script=script,
                hop=tts.cfg.acoustic_tokenizer_config.hop_length, sr=sr)


def tp_engine_run(model: dict, seed: int, mesh=None, eager: bool = False) -> dict:
    """ServingEngine(max_batch=4, max_len=4096, frames_per_dispatch=4) over
    the model (its shards under `mesh`), four requests of the two-speaker
    prompt capped at TP_ENGINE_FRAMES frames submitted at once. The initial
    latents come from one bank indexed by each slot's diffusion count (an
    injection hook), so each request's audio depends on its slot only; the
    tokens are the model's own. Rank 0 returns each request's audio and
    tokens; every rank its windows' tokens and the launches it counted."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.engine import Request, ServingEngine

    cfg, toks = model["cfg"], model["toks"]
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    n = int(proc.attention_mask.sum())
    k, b = 4, TP_ENGINE_BATCH
    eng = ServingEngine(cfg, model["params"], tokens=toks, frames_per_dispatch=k, max_batch=b,
                        max_len=4096, mesh=mesh, eager_windows=eager,
                        opts=inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096))
    g = torch.Generator(device=eng.device)
    g.manual_seed(seed + 131)
    hooks = {"forced": torch.full((k, b), -1, dtype=torch.long, device=eng.device),
             "init": torch.randn(TP_ENGINE_FRAMES + 8, b, cfg.acoustic_vae_dim, generator=g,
                                 device=eng.device)}
    real = eng.step_fn

    class Hooked:  # the engine's step function with the bank's hooks
        def __call__(self, p, c, noise, ext):
            return real(p, c, noise, ext, hooks)

        def eager(self, p, c, noise, ext):
            return real.eager(p, c, noise, ext, hooks)

    eng.step_fn = Hooked()
    reset_counts(TP_NAMES)
    out = {}
    t0 = time.perf_counter()
    try:
        if eng.leader:
            handles = [eng.submit(Request(
                input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                speech_input_mask=proc.speech_input_mask, seed=s,
                max_length_times=(TP_ENGINE_FRAMES + 0.5) / n)) for s in range(b)]
            out["audio"] = [h.result(timeout=900) for h in handles]
            out["tokens"] = [list(h.tokens) for h in handles]
    finally:
        eng.shutdown()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_counts(TP_NAMES)
    out["token_log"] = [np.asarray(x) for x in eng.token_log]
    out["replays"] = real.replays
    del eng
    return out


_IN_DECODE_STEP = [False]  # set while tp_generate's step runs (a step-only planted fault)


def tp_generate(model: dict, seed: int, frames: int, max_length: int, tp_group=None,
                eager: bool = False, windows=None, text: bool = False) -> dict:
    """Phase 4's forced script (or, with `text`, TP_TEXT_TOKEN in every
    frame) through the prefill and generate() (K = 4) at `max_length` slots
    (int8 KV from 16,384), the LM on this rank's shards under `tp_group`,
    stopped after `windows` windows if given: h_pos after the prefill, the
    valid cache of layers 0 and 27 (this rank's KV heads, dequantized), the
    audio and its first window's; with `text`, also h_pos after the last
    window and the rows of layers 0 and 27 that the windows wrote."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    cfg, params, toks = model["cfg"], model["params"], model["toks"]
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    opts = inf.resolve_kv_int8(inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3,
                                                   max_length=max_length, frames_per_dispatch=4),
                               max_length)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = int(proc.attention_mask.sum())
    last = (0, cfg.decoder_config.num_hidden_layers - 1)

    def rows(cache, start, stop):  # (2, local KV heads, rows, D) of each layer in `last`
        out = {}
        for li in last:
            kv = []
            for buf, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
                x = buf[li][0, :, start:stop].float()
                if cache.quantized:
                    x = x * scale[li][0, :, 0, start:stop, None]
                kv.append(x)
            out[li] = torch.stack(kv)
        return out

    with torch.no_grad():
        carry = inf.prefill_request(cfg, params, proc.input_ids, proc.attention_mask,
                                    proc.speech_tensors, proc.speech_masks,
                                    proc.speech_input_mask, max_length, toks, opts, gen,
                                    tp_group=tp_group)
    layers = rows(carry.cache, 0, n)
    h_pos = carry.h_pos.float().clone()
    del carry
    forced = [TP_TEXT_TOKEN] * (4 * windows) if text else forced_scripts(toks, frames)[0]
    step = inf.make_multi_step_fn(cfg, toks, opts, 4, True, tp_group)
    step = step.eager if eager else step
    final = [None]

    def recording(*a):  # the step, keeping the carry it returns
        _IN_DECODE_STEP[0] = True
        try:
            final[0], out = step(*a)
        finally:
            _IN_DECODE_STEP[0] = False
        return final[0], out

    reset_counts(TP_NAMES)
    calls = [0]

    def stop():
        calls[0] += 1
        return windows is not None and calls[0] > windows

    t0 = time.perf_counter()
    out = inf.generate(cfg, params, input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                       speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                       speech_input_mask=proc.speech_input_mask, tokens=toks, opts=opts, seed=seed,
                       forced_tokens=np.asarray(forced, np.int64)[:, None], step_fn=recording,
                       tp_group=tp_group, stop_check_fn=stop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = dict(h_pos=h_pos, layers=layers, sequences=np.array(out.sequences), wall_s=wall,
               launches=read_counts(TP_NAMES), kv_int8=bool(opts.kv_int8))
    if text:
        # the carry after the last window (a graphed step's static carry,
        # which nothing replays after generate() returns)
        res["step"] = dict(h_pos=final[0].h_pos.float().clone(),
                           layers=rows(final[0].cache, n, n + 4 * windows))
        return res
    audio = out.speech_outputs[0]
    if audio is None or not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
        fail(f"tp generate at {max_length} slots: no, non-finite or silent audio")
    hop = cfg.acoustic_tokenizer_config.hop_length
    return dict(res, audio=np.array(audio), audio_window=np.array(audio[:4 * hop]))


def tp1_end_to_end(seed: int, frames: int) -> dict:
    """Phase 13 (b): the 7B (tp_model) in a world of one over NCCL:
    ServingEngine(mesh=<tp 1>) graphed against the same engine without a
    mesh (tp_engine_run: the same tokens, audio within GRAPH_TOL; the
    window's graph captures its NCCL all-reduces), then the references of
    (c): the forced script at 4,096 bf16 and 32,768 int8 slots."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.parallel import make_mesh
    from vibevoice_tpu_torch.parallel.mesh import free_port

    t0 = time.perf_counter()
    model = tp_model(seed)
    torch.cuda.synchronize()
    print(f"  7B, dense bf16 LM + serving packs, built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card", flush=True)
    plain = tp_engine_run(model, seed)
    inf._captures.clear()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(dp=1, tp=1)
        meshed = tp_engine_run(model, seed, mesh=mesh)
        inf._captures.clear()
        refs = {length: tp_generate(model, seed, frames, length, mesh.get_group("tp"))
                for length in (4096, 32768)}
        refs["text"] = tp_generate(model, seed, frames, 4096, mesh.get_group("tp"),
                                   windows=TP_TEXT_WINDOWS, text=True)
    finally:
        dist.destroy_process_group()
    inf._captures.clear()
    errs = []
    for i, (a, b) in enumerate(zip(meshed["audio"], plain["audio"])):
        if meshed["tokens"][i] != plain["tokens"][i]:
            fail(f"tp 1 engine: request {i}'s tokens differ from the engine without a mesh")
        if a.shape != b.shape or a.size == 0:
            fail(f"tp 1 engine: request {i}'s audio has {a.size} samples, not {b.size}")
        errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
    if not meshed["replays"] > 0:
        fail("tp 1 engine: no graph replayed")
    missing = [k for k, v in meshed["launches"].items() if v == 0]
    if missing:
        fail(f"tp 1 engine: kernels never launched: {missing}")
    print(f"  world of one (NCCL, tp 1), graphed: {TP_ENGINE_BATCH} requests of "
          f"{[len(t) for t in meshed['tokens']]} frames in {meshed['wall_s']:.2f} s "
          f"({plain['wall_s']:.2f} s without a mesh), {meshed['replays']} replays, tokens equal, "
          f"audio max |diff| {max(errs):.3e} of the peak (tol {GRAPH_TOL:g}); launches "
          f"{meshed['launches']}", flush=True)
    if not max(errs) <= GRAPH_TOL:
        fail("tp 1 engine: audio differs from the engine without a mesh")
    for length, r in refs.items():
        what = (f"at 4096 slots (bf16 KV): {TP_TEXT_WINDOWS} windows forced to token "
                f"{TP_TEXT_TOKEN}" if length == "text" else
                f"at {length} slots ({'int8' if r['kv_int8'] else 'bf16'} KV): "
                f"{r['audio'].size} samples")
        print(f"  tp 1 generate {what} in {r['wall_s']:.2f} s (graphed), launches "
              f"{r['launches']}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(engine=plain, meshed=meshed, refs=refs, audio_rel_err=errs)


def _swap_with_peer(local: dict, names, group) -> dict:
    """The tree with the leaves under attn[name] of every layer replaced by
    the other rank's shards (a world of two): a planted fault."""
    import torch
    import torch.distributed as dist

    out = dict(local)
    layers = []
    me = dist.get_rank(group)
    for lp in local["lm"]["layers"]:
        attn = dict(lp["attn"])
        for name in names:
            entry = {}
            for key, x in attn[name].items():
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x.contiguous(), group=group)
                entry[key] = parts[1 - me]
            attn[name] = entry
        layers.append({**lp, "attn": attn})
    out["lm"] = {**local["lm"], "layers": layers}
    return out


def tp2_work(rank: int, port: int, seed: int, frames: int, out_path: str) -> None:
    """Phase 13 (c) on one rank of two (gloo, both ranks on cuda:0, eager
    windows): the 7B's engine run, the forced script at 4,096 bf16 and
    32,768 int8 slots and the text windows at 4,096, a train state's
    checkpoint round trip, then the text windows with each planted fault
    (the o shards swapped, the KV heads swapped, layer 0's attention
    all-reduce skipped in every forward, and in the decode step's only).
    Rank 0 gathers rank 1's KV heads and window tokens and saves the
    results."""
    import torch
    import torch.distributed as dist

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import qwen2
    from vibevoice_tpu_torch.parallel import make_mesh
    from vibevoice_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    res = {}
    try:
        t0 = time.perf_counter()
        model = tp_model(seed)
        mesh = make_mesh(dp=1, tp=2)
        group = mesh.get_group("tp")
        res["build_s"] = time.perf_counter() - t0
        engine = tp_engine_run(model, seed, mesh=mesh, eager=True)
        logs = [None, None]
        dist.all_gather_object(logs, engine["token_log"], group=group)
        res["engine"], res["engine_logs"] = engine, logs
        cfg = model["cfg"]
        full = model["params"]
        model["params"] = pmesh.shard_params(full, pmesh.model_param_shardings(
            full, mesh, cfg.decoder_config.head_dim), mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

        def gather_heads(layers):  # every rank's KV heads, in rank order
            for li, x in layers.items():
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x.contiguous(), group=group)
                layers[li] = torch.cat(parts, dim=1).cpu()

        def run(length, params=None, text=False):
            kw = {} if params is None else {"params": params}
            r = tp_generate({**model, **kw}, seed, frames, length, group, eager=True,
                            windows=TP_TEXT_WINDOWS if text else None, text=text)
            gather_heads(r["layers"])
            r["h_pos"] = r["h_pos"].cpu()
            if text:
                gather_heads(r["step"]["layers"])
                r["step"]["h_pos"] = r["step"]["h_pos"].cpu()
            inf._captures.clear()
            return r

        res["runs"] = {length: run(length) for length in (4096, 32768)}
        res["runs"]["text"] = run(4096, text=True)
        res["checkpoint"] = tp2_checkpoint_roundtrip(model, mesh, seed)
        faults = {}
        faults["o shards swapped"] = run(4096, _swap_with_peer(model["params"], ("o",), group),
                                         text=True)
        faults["KV heads swapped"] = run(4096, _swap_with_peer(model["params"], ("k", "v"),
                                                               group), text=True)
        real, calls = qwen2.reduce_from_group, [0, 0]
        n_calls = 2 * cfg.decoder_config.num_hidden_layers

        def skipping(x, grp):  # layer 0's attention all-reduce, in every forward
            calls[0] += 1
            return x if calls[0] % n_calls == 1 else real(x, grp)

        def skipping_in_step(x, grp):  # the same, in the decode step's forwards only
            if not _IN_DECODE_STEP[0]:
                return real(x, grp)
            calls[1] += 1
            return x if calls[1] % n_calls == 1 else real(x, grp)

        for name, fn in (("layer 0's attention all-reduce skipped", skipping),
                         ("the same, in the decode step only", skipping_in_step)):
            qwen2.reduce_from_group = fn
            try:
                faults[name] = run(4096, text=True)
            finally:
                qwen2.reduce_from_group = real
        res["faults"] = faults
    finally:
        dist.destroy_process_group()
    if rank == 0:
        import torch as _t

        _t.save(res, out_path)


def tp2_checkpoint_roundtrip(model: dict, mesh, seed: int) -> dict:
    """A tp 2 train state (this rank's shards of the 7B's first layer's
    attention, bf16, with f32 AdamW moments drawn at random, count and step 3) saved
    through utils/checkpoint.save_train_state (each rank writes its own
    shards) and restored into zeros of the same layout: whether every
    tensor and value came back bit-equal, and the bytes written."""
    import shutil

    import torch

    from vibevoice_tpu_torch.finetune import train_step as tts
    from vibevoice_tpu_torch.parallel import mesh as pmesh
    from vibevoice_tpu_torch.utils import checkpoint as ck

    lm = model["params"]["lm"]
    params = {"attn": lm["layers"][0]["attn"]}
    specs = {"attn": pmesh.qwen2_param_shardings(lm, mesh)["layers"][0]["attn"]}
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 132)
    leaves = dict(tts.tree_leaves_with_path(params))
    rand = lambda: {p: torch.randn(x.shape, generator=g, device="cuda") for p, x in leaves.items()}
    state = tts.TrainState(params, tts.OptState(3, rand(), rand(), 0, rand()), 3)
    by_path = {p: tts._spec_of(specs, p) for p in leaves}
    st_specs = tts.TrainState(specs, tts.OptState((), by_path, by_path, (), by_path), ())
    path = ROOT / "build" / "phase13" / "state"
    t0 = time.perf_counter()
    ck.save_train_state(str(path), state, mesh, st_specs)
    save_s = time.perf_counter() - t0
    zeros = lambda d: {p: torch.zeros_like(x) for p, x in d.items()}
    target = tts.TrainState(
        pmesh._tree_map(torch.zeros_like, params),
        tts.OptState(0, zeros(state.opt_state.mu), zeros(state.opt_state.nu), 0,
                     zeros(state.opt_state.acc)), 0)
    t0 = time.perf_counter()
    back = ck.restore_train_state(str(path), target, mesh, st_specs)
    restore_s = time.perf_counter() - t0
    pairs = list(zip(tts.tree_leaves_with_path(back.params), tts.tree_leaves_with_path(params)))
    for name in ("mu", "nu", "acc"):
        got, want = getattr(back.opt_state, name), getattr(state.opt_state, name)
        pairs += [((p, got[p]), (p, want[p])) for p in want]
    same = all(torch.equal(a, b) for (_, a), (_, b) in pairs) and (
        back.opt_state.count, back.step) == (3, 3)
    n_bytes = sum(x.numel() * x.element_size() for (_, x) in (b for _, b in pairs))
    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    return dict(same=same, rank_bytes=n_bytes, save_s=save_s, restore_s=restore_s)


def _tp2_rank1(port: int, seed: int, frames: int) -> None:
    sys.path.insert(0, str(ROOT))
    tp2_work(1, port, seed, frames, "")


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def tp_compare(got: dict, ref: dict) -> dict:
    """max |diff| over the peak of h_pos and layers 0 and 27's caches of a
    tp 2 run against the tp 1 reference (the held readings)."""
    out = {"h_pos": _rel(got["h_pos"], ref["h_pos"].cpu())}
    for li in ref["layers"]:
        out[f"layer {li}"] = _rel(got["layers"][li], ref["layers"][li].cpu())
    return out


def tp_limits(readings: dict, step: dict) -> float:
    """The largest reading over its limit: TP_TOL["bf16"] for the prefill's
    (`readings`), TP_STEP_TOL for the decode step's (`step`)."""
    return max([v / TP_TOL["bf16"] for v in readings.values()]
               + [v / TP_STEP_TOL for v in step.values()])


def tp_audio(got: dict, ref: dict) -> dict:
    """The audio's readings (printed, not held: TP_TOL's comment); the
    whole audio where the run was not stopped early."""
    out = {"first window's audio": _rel(got["audio_window"], ref["audio_window"])}
    if got["audio"].shape == ref["audio"].shape:
        out["whole audio"] = _rel(got["audio"], ref["audio"])
    return out


def tp2_end_to_end(seed: int, frames: int, tp1: dict) -> dict:
    """Phase 13 (c): tp2_work on two ranks on the one card (this process is
    rank 0), held against (b)'s world of one: the engine's tokens equal on
    both ranks and equal to tp 1's, the forced script's tokens equal and its
    h_pos and caches within TP_TOL (its audio printed), the text windows'
    state after the prefill within TP_TOL and after the last window within
    TP_STEP_TOL; each planted fault reads at least TP_FAULT_FACTOR times its
    limits (the decode step's, for the fault that acts there only)."""
    import multiprocessing as mp

    import torch

    from vibevoice_tpu_torch.parallel.mesh import free_port

    out_path = ROOT / "build" / "phase13" / "tp2.pt"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    port = free_port()
    proc = mp.get_context("spawn").Process(target=_tp2_rank1, args=(port, seed, frames),
                                           daemon=True)
    proc.start()
    t0 = time.perf_counter()
    try:
        tp2_work(0, port, seed, frames, str(out_path))
    finally:
        proc.join(600)
        if proc.is_alive():
            proc.kill()
    wall = time.perf_counter() - t0
    if proc.exitcode != 0:
        fail(f"tp 2 rank 1 exited with {proc.exitcode}")
    res = torch.load(out_path, weights_only=False)
    out_path.unlink()
    import numpy as np

    logs = res["engine_logs"]
    if not (len(logs[0]) == len(logs[1]) > 0
            and all(np.array_equal(a, b) for a, b in zip(*logs))):
        fail("tp 2 engine: the two ranks chose different tokens")
    engine = res["engine"]
    ref_engine = tp1["meshed"]
    engine_errs, engine_whole = [], []
    window = 4 * CONFIG_HOP
    for i, (a, b) in enumerate(zip(engine["audio"], ref_engine["audio"])):
        if engine["tokens"][i] != ref_engine["tokens"][i]:
            fail(f"tp 2 engine: request {i}'s tokens differ from tp 1's")
        engine_errs.append(_rel(a[:window], b[:window]))
        engine_whole.append(_rel(a, b))
    missing = [k for k, v in engine["launches"].items() if v == 0]
    if missing:
        fail(f"tp 2 engine: kernels never launched: {missing}")
    readings = {}
    text = res["runs"].pop("text")
    for length, r in res["runs"].items():
        kv = "int8" if r["kv_int8"] else "bf16"
        cmp = tp_compare(r, tp1["refs"][length])
        if not np.array_equal(r["sequences"], tp1["refs"][length]["sequences"]):
            fail(f"tp 2 generate at {length}: tokens differ from tp 1's")
        audio = tp_audio(r, tp1["refs"][length])
        readings[f"{length} {kv}"] = {**cmp, **audio}
        print(f"  tp 2 (gloo, eager) against tp 1 at {length} slots ({kv} KV): "
              + ", ".join(f"{k} {v:.3e}" for k, v in cmp.items())
              + f" of the peak (limit {TP_TOL[kv]:g}); not held: "
              + ", ".join(f"{k} {v:.3e}" for k, v in audio.items())
              + f"; tokens equal; {r['wall_s']:.2f} s, launches {r['launches']}", flush=True)
        if not max(cmp.values()) <= TP_TOL[kv]:
            fail(f"tp 2 at {length} slots differs from tp 1 beyond {TP_TOL[kv]:g}: {cmp}")
    ref = tp1["refs"]["text"]
    if not np.array_equal(text["sequences"], ref["sequences"]):
        fail("tp 2 text windows: tokens differ from tp 1's")
    cmp, step = tp_compare(text, ref), tp_compare(text["step"], ref["step"])
    readings["text"] = {**cmp, **{"step " + k: v for k, v in step.items()}}
    print(f"  tp 2 (gloo, eager) against tp 1 (graphed), {TP_TEXT_WINDOWS} windows forced to "
          f"token {TP_TEXT_TOKEN} at 4096 slots: after the prefill "
          + ", ".join(f"{k} {v:.3e}" for k, v in cmp.items())
          + f" (limit {TP_TOL['bf16']:g}); after the last window "
          + ", ".join(f"{k} {v:.3e}" for k, v in step.items())
          + f" of the peak (limit {TP_STEP_TOL:g}; the layers' rows the windows wrote); "
          f"{text['wall_s']:.2f} s", flush=True)
    if not tp_limits(cmp, step) <= 1.0:
        fail(f"tp 2 text windows differ from tp 1 beyond the limits: {readings['text']}")
    fault_readings = {}
    for name, r in res["faults"].items():
        cmp, step = tp_compare(r, ref), tp_compare(r["step"], ref["step"])
        fault_readings[name] = {**cmp, **{"step " + k: v for k, v in step.items()}}
        print(f"  planted fault, {name}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in fault_readings[name].items()), flush=True)
        worst = tp_limits({}, step) if "decode step only" in name else tp_limits(cmp, step)
        if not worst >= TP_FAULT_FACTOR:
            fail(f"planted fault {name!r} reads {worst:.2f}x its limits, not {TP_FAULT_FACTOR}x")
    print(f"  tp 2 engine (gloo, eager windows): {TP_ENGINE_BATCH} requests in "
          f"{engine['wall_s']:.2f} s, tokens equal on both ranks and to tp 1's; not held: the "
          f"first window's audio max |diff| {max(engine_errs):.3e} of the peak, the whole "
          f"requests' {max(engine_whole):.3e}; rank 0's peak {res['peak_gib']:.2f} GiB; launches "
          f"{engine['launches']}; the phase's two-rank part {wall:.1f} s", flush=True)
    ckpt = res["checkpoint"]
    print(f"  tp 2 train state through utils/checkpoint (the 7B's layer-0 attention shards and "
          f"AdamW moments, {ckpt['rank_bytes']} bytes a rank): saved in {ckpt['save_s']:.2f} s, "
          f"restored in {ckpt['restore_s']:.2f} s, "
          f"{'the same bits' if ckpt['same'] else 'DIFFERENT'}", flush=True)
    if not ckpt["same"]:
        fail("tp 2 train state: the restored checkpoint differs from the saved one")
    launches = dict(engine["launches"])
    for r in list(res["runs"].values()) + [text]:
        for k, v in r["launches"].items():
            launches[k] += v
    return dict(readings=readings, faults=fault_readings, engine_rel_err=engine_errs,
                engine_whole_rel_err=engine_whole, engine_wall_s=engine["wall_s"], wall_s=wall,
                peak_gib=res["peak_gib"], launches=launches, checkpoint=ckpt)


def tp_trainer(seed: int) -> dict:
    """Phase 13 (c), the trainer: the full-width 1.5B, --use_lora over the
    dense f32 base, B2 T1024, 3 steps from the first update on (warmup 0),
    on one rank, under --mesh_tp 2 and under --mesh_dp 2, both ranks on
    the one card (so over gloo; this process is rank 0). Against one rank's
    run: step 1's loss within TP_TRAIN_TOL, the losses of steps 2-3, which
    the updates shaped, within TP_TRAIN_STEP_TOL, and the adapters after
    step 3 within TP_TRAIN_ADAPTER_TOL of their change (the worst leaf);
    s/step and each rank's peak memory."""
    import torch

    from vibevoice_tpu_torch.finetune import train
    from vibevoice_tpu_torch.finetune.train_step import tree_leaves_with_path

    common = ["--config", str(CONFIG_1P5B), "--seed", str(seed), "--no_save"] + TP_TRAIN_COMMON
    runs = (("one rank", ["--per_device_batch_size", "2"]),
            ("tp 2", ["--mesh_tp", "2", "--per_device_batch_size", "2"]),
            ("dp 2", ["--mesh_dp", "2", "--per_device_batch_size", "1"]))
    names = ("flash_train_attention_fwd", "flash_train_attention_bwd")
    recs, adapters = {}, {}
    for label, extra in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(names)
        t0 = time.perf_counter()
        summary = train.main(common + extra)
        wall = time.perf_counter() - t0
        steps = summary["steps"]
        if not all(math.isfinite(s["loss"]) for s in steps):
            fail(f"trainer {label}: non-finite loss {[s['loss'] for s in steps]}")
        init = dict(tree_leaves_with_path(summary["lora_init"]))
        adapters[label] = {p: (x.float().cpu(), init[p].float().cpu())
                           for p, x in tree_leaves_with_path(summary["lora"])}
        sec = sum(s["seconds"] for s in steps[1:]) / len(steps[1:])
        recs[label] = dict(losses=[s["loss"] for s in steps], seconds_per_step=sec,
                           peak_gib_per_rank=[p / 2**30 for p in summary["peak_bytes_per_rank"]],
                           wall_s=wall, launches=read_counts(names))
        del summary
        print(f"  trainer {label}: losses {[round(s['loss'], 5) for s in steps]}, "
              f"{sec:.3f} s/step (steps 2-3), peak "
              f"{', '.join(f'{p:.2f}' for p in recs[label]['peak_gib_per_rank'])} GiB a rank, "
              f"wall {wall:.1f} s, launches {recs[label]['launches']}", flush=True)
    one, ref = recs["one rank"]["losses"], adapters["one rank"]
    changed = sum(int(not torch.equal(x, x0)) for x, x0 in ref.values())
    if not changed > 0:
        fail("trainer one rank: no adapter changed over three steps")
    for label in ("tp 2", "dp 2"):
        got = recs[label]["losses"]
        errs = [abs(g - o) / abs(o) for g, o in zip(got, one)]
        worst, worst_leaf = 0.0, None
        for path, (x, _) in adapters[label].items():
            y, y0 = ref[path]
            moved = float((y - y0).norm())
            if moved > 0:
                r = float((x - y).norm()) / moved
                if r > worst:
                    worst, worst_leaf = r, path
        recs[label].update(loss_rel_err=errs, adapter_rel_err=worst,
                           adapter_worst_leaf=str(worst_leaf))
        print(f"  trainer {label} against one rank: losses {errs[0]:.2e} (step 1, tol "
              f"{TP_TRAIN_TOL:g}), {max(errs[1:]):.2e} (steps 2-3, tol {TP_TRAIN_STEP_TOL:g}) "
              f"relative; the adapters after step 3 {worst:.2e} of their change (worst leaf "
              f"{worst_leaf}, tol {TP_TRAIN_ADAPTER_TOL:g}; {changed} of {len(ref)} leaves moved)",
              flush=True)
        if not errs[0] <= TP_TRAIN_TOL:
            fail(f"trainer {label}: step 1's loss is {errs[0]:.2e} off one rank's")
        if not max(errs[1:]) <= TP_TRAIN_STEP_TOL:
            fail(f"trainer {label}: the losses of steps 2-3 are {max(errs[1:]):.2e} off one rank's")
        if not worst <= TP_TRAIN_ADAPTER_TOL:
            fail(f"trainer {label}: the adapters after step 3 differ from one rank's by "
                 f"{worst:.2e} of their change ({worst_leaf})")
    if not recs["tp 2"]["launches"]["flash_train_attention_fwd"] > 0:
        fail("trainer tp 2: the training attention never launched")
    return dict(runs=recs)


def multi_card_note() -> str:
    """Phase 13 (d): what the machine's cards let run here."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return (f"{n} cards: FSDP and GPipe over NCCL and the graphed TP engine at tp 2 (and 4 with "
                f"four cards) run in tests/test_torch_cuda.py -m cuda -k multi_card")
    return ("one card: FSDP and GPipe over NCCL and the graphed NCCL TP engine at tp 2 and 4 need "
            "two or more cards and did not run here (tests/test_torch_cuda.py -m cuda -k "
            "multi_card, on four cards)")


def tensor_parallel(checks: Checks, seed: int, frames: int) -> dict:
    """Phase 13: (a) check_tp_kernels ("<kernel>@tp" entries), (b)
    tp1_end_to_end, (c) tp2_end_to_end and tp_trainer, (d) the note on
    multi-card cases. The "@tp" entries count the launches of (c)'s tp 2
    runs (B) and its tp 2 trainer (the training attention); C's, D's and
    B's launches at the 7B's full heads in (b) go to their "@7b" entries."""
    import torch

    t0 = time.perf_counter()
    walls = {}
    checks.tag = "@tp"
    try:
        check_tp_kernels(checks, seed)
    finally:
        checks.tag = ""
    walls["kernels"] = time.perf_counter() - t0
    t = time.perf_counter()
    tp1 = tp1_end_to_end(seed, frames)
    for name, n in tp1["meshed"]["launches"].items():
        checks.kernels[name + "@7b"]["launches"] += n
    walls["tp1"] = time.perf_counter() - t
    t = time.perf_counter()
    tp2 = tp2_end_to_end(seed, frames, tp1)
    for name in ("flash_cached_attention", "flash_cached_attention_prefill"):
        checks.kernels[name + "@tp"]["launches"] += tp2["launches"][name]
    walls["tp2"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    trainer = tp_trainer(seed)
    for name, n in trainer["runs"]["tp 2"]["launches"].items():
        checks.kernels[name + "@tp"]["launches"] += n
    walls["trainer"] = time.perf_counter() - t
    note = multi_card_note()
    walls["phase"] = time.perf_counter() - t0
    print(f"  multi-card cases: {note}", flush=True)
    print("  phase 13 walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)
    tp1 = {k: v for k, v in tp1.items() if k != "refs"}
    for r in (tp1["engine"], tp1["meshed"]):
        r.pop("audio", None)
        r.pop("token_log", None)
    return dict(tp1=tp1, tp2=tp2, trainer=trainer, multi_card=note, walls=walls)


# ---------------------------------------------------------------------------
# Phase 14: the rest of the JAX package's surface on one card
# ---------------------------------------------------------------------------

# Kernel A's shapes on the surface (name, IN, OUT, the rows of its cases,
# the main case's rows), by kernels-line tag: the packed q|k|v and gate|up
# of an int8 LM (LM_PACK=1), the int8 diffusion head (FFN ratio 3; AdaLN
# at K x 2B = 20 rows at bs1, 10 steps; bs4's 80 rows take the GEMM, a card
# test's case) and the int8 tokenizer FFNs (C, 4C) at C = 512, 1024, 2048:
# 1 row a frame at the T = 1 stages, 45-90 rows in a 3 s voice prompt's
# encode (the GEMM, "int8_matmul_gemm@tok"; 300 at C = 2048 for a 10 s one).
SURFACE_KERNELS = {
    "@pack": (("qkv", 1536, 2048, (2, 8), None), ("gate|up", 1536, 17920, (2, 8), 2)),
    "@head": (("ffn gate/up", 1536, 4608, (2, 8), 2), ("ffn down", 4608, 1536, (2, 8), None),
              ("adaln", 1536, 4608, (20,), None)),
    "@tok": (("C 512 fc1", 512, 2048, (1, 4, 90), None), ("C 512 fc2", 2048, 512, (1, 90), None),
             ("C 1024 fc1", 1024, 4096, (1, 45), None),
             ("C 1024 fc2", 4096, 1024, (1, 45), None),
             ("C 2048 fc1", 2048, 8192, (1, 4, 300), 1), ("C 2048 fc2", 8192, 2048, (1, 300), 300)),
    "@pack@7b": (("qkv", 3584, 4608, (2, 8), None), ("gate|up", 3584, 37888, (2, 8), 2)),
    "@head@7b": (("ffn gate/up", 3584, 10752, (2, 8), 2), ("ffn down", 10752, 3584, (2,), None),
                 ("adaln", 3584, 10752, (20,), None)),
}
SURFACE_ENTRIES = ("int8_matmul@pack", "int8_matmul@head", "int8_matmul@tok",
                   "int8_matmul_gemm@tok", "int8_matmul@pack@7b", "int8_matmul@head@7b")
ALL_COMPONENTS = ("lm", "lm_head", "diffusion_head", "tokenizers")
SURFACE_REPEATS = 3  # alternated timings of two variants, medians printed
# LM_PACK=1 against unpacked, h_pos after the prefill: kernel A's GEMM
# never splits K and computes each column alone, so the packed weights give
# the same bits (H100, --seed 0: 0.0). The decode GEMV's K split follows
# OUT, so the packed frames round otherwise and the random-weight audio
# drifts (0.935 of the peak after 32 frames): printed, not held.
PACK_HPOS_TOL = 0.0
# The 512-wide int8 model on the card against the CPU, audio over its peak:
# the CPU's own plain version with f64 sums in place of f32 moves this
# audio by 1.14e-3 of the peak (3.2e-4 with only the LM int8), so summation
# order alone spreads it that far; the card read 1.28e-3 (H100, --seed 0).
SMALL_CARD_TOL = 5e-3
THRESHOLD_TOL = 1e-5
DOTS_LOSS_TOL = 1e-6  # "dots" against full remat, relative, each step
SURFACE_ROOT = ROOT / "build" / "phase14"
FINETUNE_RUNS_DOTS = (
    ("B2 T2048 remat", ["--per_device_batch_size", "2", "--max_length", "2048",
                        "--pad_to_multiple", "2048", "--synthetic_seconds", "220", "250",
                        "--max_steps", "3", "--remat"]),
    ("B2 T2048 remat dots", ["--per_device_batch_size", "2", "--max_length", "2048",
                             "--pad_to_multiple", "2048", "--synthetic_seconds", "220", "250",
                             "--max_steps", "3", "--remat", "--remat_policy", "dots",
                             "--output_dir", str(SURFACE_ROOT / "trained")]))


def check_surface_kernels(checks: Checks, seed: int) -> None:
    """Phase 14 (a): kernel A at every shape of SURFACE_KERNELS against its
    plain version (tol 1e-2, bf16 x), timed with its bound and torch.mm on a
    bf16 copy (check_int8_matmul), each case replayed from one CUDA-graph
    capture with new x against its eager call (the same bits), the GEMV's
    2-row or 1-row case also against the plain version (gemv_graph_check).
    The main case of each entry fills its ms."""
    import torch

    from vibevoice_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 14)
    randn = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=g, device=dev).to(dt)
    print("kernel A int8_matmul at the surface's shapes: packed q|k|v and gate|up, the int8 "
          "head, the int8 tokenizer FFNs (bf16 x, int8 w, f32 scale; tol 1e-2; library: "
          "torch.mm on a bf16 copy of the weight)", flush=True)
    try:
        for tag, shapes in SURFACE_KERNELS.items():
            checks.tag = tag
            for name, k, n, rows_list, main_rows in shapes:
                ws = rotating(lambda: quant.quantize_weight(randn(k, n, dt=torch.float32) * 0.02),
                              k * n)
                for rows in rows_list:
                    x = randn(rows, k)
                    label = f"{name} {k}x{n} rows={rows}"
                    check_int8_matmul(checks, label, x, ws, 1e-2, main=rows == main_rows)
                    if rows == rows_list[0] and quant._plan(rows, k, n).route == "gemv":
                        gemv_graph_check(checks, label, x, ws[0])
                    graph_vs_eager(checks, "int8_matmul" if quant._plan(rows, k, n).route ==
                                   "gemv" else "int8_matmul_gemm", label,
                                   lambda: quant.int8_matmul(x, ws[0]["w8"], ws[0]["scale"]), (x,))
                del ws
                torch.cuda.empty_cache()
    finally:
        checks.tag = ""


def _timed_generate(cfg, params, proc, toks, seed, opts, script, step_fn=None):
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = inf.generate(cfg, params, input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                       speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                       speech_input_mask=proc.speech_input_mask, tokens=toks, seed=seed,
                       opts=opts, step_fn=step_fn,
                       forced_tokens=np.asarray(script, np.int64)[:, None])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def alternated_frames(model: dict, seed: int, frames: int, variants: dict) -> dict:
    """Graphed (K = 4, 4,096 bf16 slots) forced runs of each params variant
    of the one model, taken in turn SURFACE_REPEATS times (A, B, A, B, ...)
    after one capturing run each: ms a frame from the `frames`- and 3-frame
    runs' walls, the median and every reading; the last run's outputs (a
    copy) and launches of SURFACE_ENTRIES' wrappers."""
    import numpy as np

    from vibevoice_tpu_torch.models import inference as inf

    cfg, toks = model["cfg"], model["toks"]
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    forced, short = forced_scripts(toks, frames)
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096,
                               frames_per_dispatch=4)
    names = ("int8_matmul", "int8_matmul_gemm", "flash_cached_attention",
             "flash_cached_attention_prefill", "fused_head_ffn_stack", "fused_stage_step")
    for params in variants.values():
        _timed_generate(cfg, params, proc, toks, seed, opts, short)  # captures
    rec = {name: dict(per_frame_ms=[]) for name in variants}
    for _ in range(SURFACE_REPEATS):
        for name, params in variants.items():
            reset_counts(names)
            out, wall = _timed_generate(cfg, params, proc, toks, seed, opts, forced)
            counts = read_counts(names)
            short_wall = _timed_generate(cfg, params, proc, toks, seed, opts, short)[1]
            rec[name]["per_frame_ms"].append((wall - short_wall) / (len(forced) - len(short)) * 1e3)
            audio = out.speech_outputs[0]
            if audio is None or not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
                fail(f"{name}: no, non-finite or silent audio")
            rec[name].update(sequences=np.array(out.sequences), audio=np.array(audio),
                             launches=counts)
    for name, r in rec.items():
        r["median_ms"] = float(np.median(r["per_frame_ms"]))
    return rec


def replay_frame_ms(model: dict, seed: int, variants: dict, frames: int = 17) -> dict:
    """Device time a frame of one replayed window of `frames` forced speech
    frames (make_multi_step_fn at 4,096 slots, CUDA events, as
    graphed_profile times it) for each params variant of the one model:
    each variant prefilled and captured, then the replays taken in turn
    SURFACE_REPEATS times; the median and every reading."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf

    cfg, toks = model["cfg"], model["toks"]
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = proc.input_ids.shape[0]
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096)
    fn = inf.make_multi_step_fn(cfg, toks, opts, frames, inject=True)
    hooks = {"init": torch.randn(1, b, cfg.acoustic_vae_dim, generator=g, device=dev),
             "forced": torch.full((frames, b), toks.speech_diffusion, device=dev)}
    noise = inf.draw_noise(cfg, opts, b, g, frames=frames, inject=True)
    ext = torch.zeros(frames, b, dtype=torch.bool, device=dev)
    carries = {}
    for name, params in variants.items():
        speech_args = (torch.as_tensor(proc.speech_tensors, device=dev, dtype=torch.float32),
                       torch.as_tensor(proc.speech_masks, device=dev),
                       torch.as_tensor(proc.speech_input_mask, device=dev), g, None)
        carry = inf.prefill_fn(cfg, params, torch.as_tensor(proc.input_ids, device=dev), 4096,
                               torch.as_tensor(proc.attention_mask, device=dev), speech_args,
                               toks)
        carries[name] = fn(params, carry, noise, ext, hooks)[0]  # the capture and a replay
    ms = {name: [] for name in variants}
    for _ in range(SURFACE_REPEATS):
        for name, params in variants.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            carries[name], _ = fn(params, carries[name], noise, ext, hooks)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end) / frames)
    return {name: dict(per_frame_ms=v, median_ms=float(np.median(v))) for name, v in ms.items()}


def lm_pack_end_to_end(model: dict, seed: int, frames: int) -> dict:
    """Phase 14 (b): VibeVoiceTTS.random built again with LM_PACK=1 in the
    environment (fuse_for_serving packs the int8 LM's q|k|v and gate|up,
    ops/quant.pack_lm_projections) against phase 4's model: h_pos after the
    prefill of the two-speaker prompt (A's GEMM on the packed weights)
    within PACK_HPOS_TOL of the peak (the same bits), and the forced
    `frames`-frame graphed
    generate() (K = 4, 4,096 slots): the same tokens, audio compared (the
    bits and max |diff|; the GEMV's K split depends on OUT, so packed sums
    may be ordered otherwise), ms a frame of both taken in turn."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.tts import VibeVoiceTTS

    os.environ["LM_PACK"] = "1"
    try:
        packed = VibeVoiceTTS.random(str(CONFIG_1P5B), seed=seed).params
    finally:
        os.environ.pop("LM_PACK")
    layer = packed["lm"]["layers"][0]
    if "qkv" not in layer["attn"] or "gateup" not in layer["mlp"] or "q" in layer["attn"]:
        fail(f"LM_PACK=1: the LM is not packed: {sorted(layer['attn'])}, {sorted(layer['mlp'])}")
    cfg, toks = model["cfg"], model["toks"]
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    dev = torch.device("cuda")
    ids = torch.from_numpy(proc.input_ids).to(dev)
    mask = torch.from_numpy(proc.attention_mask).to(dev)
    with torch.no_grad():
        hs = [inf.prefill_fn(cfg, p, ids, 4096, mask, None, toks).h_pos.float()
              for p in (model["params"], packed)]
    hpos = float((hs[1] - hs[0]).abs().max() / hs[0].abs().max())
    variants = {"unpacked": model["params"], "packed": packed}
    rec = alternated_frames(model, seed, frames, variants)
    device = replay_frame_ms(model, seed, variants)
    u, p = rec["unpacked"], rec["packed"]
    same_tokens = np.array_equal(u["sequences"], p["sequences"])
    same_bits = same_tokens and np.array_equal(u["audio"], p["audio"])
    audio_err = float(np.abs(u["audio"] - p["audio"]).max() / np.abs(u["audio"]).max())
    print(f"  LM_PACK=1 against unpacked: h_pos after the {proc.input_ids.shape[1]}-token "
          f"prefill {hpos:.3e} of the peak (tol {PACK_HPOS_TOL:g}); forced {frames}-frame "
          f"graphed runs: tokens {'equal' if same_tokens else 'DIFFER'}, audio bits "
          f"{'equal' if same_bits else 'differ'} (max |diff| {audio_err:.3e} of the peak); ms a "
          f"frame unpacked {u['median_ms']:.3f} (median of {u['per_frame_ms']}), packed "
          f"{p['median_ms']:.3f} (median of {p['per_frame_ms']}); device time a frame of a "
          f"replayed 17-frame window unpacked {device['unpacked']['median_ms']:.3f} (median of "
          f"{device['unpacked']['per_frame_ms']}), packed {device['packed']['median_ms']:.3f} "
          f"(median of {device['packed']['per_frame_ms']}); launches unpacked "
          f"{u['launches']}, packed {p['launches']}", flush=True)
    if not same_tokens:
        fail("LM_PACK=1: tokens differ from the unpacked run")
    if not hpos <= PACK_HPOS_TOL:
        fail(f"LM_PACK=1: h_pos after the prefill {hpos:.3e} of the peak from the unpacked one")
    del packed
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for r in rec.values():
        r.pop("audio")
        r.pop("sequences")
    return dict(hpos_rel_err=hpos, audio_rel_err=audio_err, same_audio_bits=same_bits,
                runs=rec, device=device, launches=p["launches"])


def small_int8_card_vs_cpu(seed: int) -> dict:
    """Phase 14 (c1): the 512-wide, 2-layer config (tiny_config(hidden_size=
    512, n_filters=128): a 512-1536-512 head and 512-2048-512 tokenizer
    stages, which the 512 rule quantizes) with the LM, lm_head, head and
    tokenizers int8, the forced generate() on the card (graphed) against
    the same on the CPU (the plain versions): the same tokens, audio within
    SMALL_CARD_TOL of the peak."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.utils.params import init

    cfg = tiny_config(hidden_size=512, n_filters=128)
    hop = cfg.acoustic_tokenizer_config.hop_length
    toks = inf.SpecialTokens(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
    rng = np.random.RandomState(seed)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6], ids[0, -1] = 7, 5
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    kw = dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * hop).astype(np.float32),
              speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask, tokens=toks,
              noise_bank={"init": rng.randn(16, 1, cfg.acoustic_vae_dim).astype(np.float32),
                          "vae_std": rng.randn(1).astype(np.float32),
                          "vae_eps": rng.randn(1, 4, cfg.acoustic_vae_dim).astype(np.float32)},
              forced_tokens=np.array([7, 7, 7, 6, 5, 7, 7, 7, 2])[:, None],
              opts=inf.GenerateOptions(ddpm_steps=4, max_length=64, frames_per_dispatch=4))
    p = init(cfg, seed=seed, device="cpu")
    for part in (p["acoustic_tokenizer"]["decoder"], p["semantic_tokenizer"]["encoder"]):
        for blk in (b for stage in part["stages"] for b in stage):  # make the blocks work
            blk["gamma"].fill_(0.3)
            blk["ffn_gamma"].fill_(0.3)
    p = vv.quantize_for_inference(p, ALL_COMPONENTS)
    names = ("int8_matmul",)
    reset_counts(names)
    card = inf.generate(cfg, _to(p, "cuda"), **kw)
    counts = read_counts(names)
    cpu = inf.generate(cfg, p, **kw)
    a, b = card.speech_outputs[0], cpu.speech_outputs[0]
    err = float(np.abs(a - b).max() / np.abs(b).max())
    same = np.array_equal(card.sequences, cpu.sequences)
    print(f"  512-wide int8 LM, head and tokenizers, card (graphed) against the CPU: tokens "
          f"{'equal' if same else 'DIFFER'}, {len(a)} samples, audio max |diff| {err:.3e} of the "
          f"peak (tol {SMALL_CARD_TOL:g}), A's launches {counts}", flush=True)
    if not same or not err <= SMALL_CARD_TOL or not counts["int8_matmul"] > 0:
        fail("512-wide int8 model: the card's run disagrees with the CPU's")
    inf._captures.clear()
    return dict(rel_err=err, launches=counts)


def int8_head_end_to_end(model: dict, seed: int, frames: int) -> dict:
    """Phase 14 (c2): the full-width 1.5B with quantize_for_inference of
    all four components (the int8 LM and lm_head as phase 4's; the head's
    AdaLN and FFN linears and the tokenizers' 512-, 1024- and 2048-wide
    ConvNeXt FFNs int8, unfused: kernel A where the serving packs run C
    and D): the forced generate() graphed (K = 4) against its eager step
    (the same tokens, audio within GRAPH_TOL; expected the same bits), then
    ms a frame beside phase 4's fused model, taken in turn; fuse_for_serving
    must refuse the int8 head. Then utils.profiling.trace around one
    graphed window of the int8 model, whose named phases must be found
    among the profile's events and in its Chrome trace."""
    import json as json_

    import numpy as np
    import torch

    from vibevoice_tpu_torch.configs import VibeVoiceConfig
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.utils import profiling
    from vibevoice_tpu_torch.utils.params import init

    cfg, toks = model["cfg"], model["toks"]
    t0 = time.perf_counter()
    dense = init(VibeVoiceConfig.from_json_file(str(CONFIG_1P5B)), seed=seed,
                 dtype=torch.bfloat16)
    q8 = vv.quantize_for_inference(dense, ALL_COMPONENTS)
    del dense
    try:
        vv.fuse_for_serving(q8, cfg)
        fail("fuse_for_serving took an int8 diffusion head")
    except ValueError as e:
        if "int8 head" not in str(e):
            raise
    n_int8 = sum(1 for part in ("acoustic_tokenizer", "semantic_tokenizer")
                 for sub in q8[part].values() for stage in sub["stages"] for blk in stage
                 for lin in blk["ffn"].values() if "w8" in lin)
    print(f"  int8 LM, lm_head, head and tokenizers built in {time.perf_counter() - t0:.1f} s; "
          f"{n_int8} int8 tokenizer FFN linears", flush=True)
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    forced, short = forced_scripts(toks, frames)
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096,
                               frames_per_dispatch=4)
    fn = inf.make_multi_step_fn(cfg, toks, opts, 4, inject=True)
    variants = {"fused": model["params"], "int8 head": q8}
    rec = alternated_frames(model, seed, frames, variants)
    device = replay_frame_ms(model, seed, variants)
    graphed = rec["int8 head"]
    eager, _ = _timed_generate(cfg, q8, proc, toks, seed, opts, forced, fn.eager)
    same_tokens = np.array_equal(eager.sequences, graphed["sequences"])
    err = float(np.abs(eager.speech_outputs[0] - graphed["audio"]).max()
                / np.abs(graphed["audio"]).max())
    f, i = rec["fused"], rec["int8 head"]
    print(f"  int8 head and tokenizers: graphed against eager tokens "
          f"{'equal' if same_tokens else 'DIFFER'}, audio max |diff| {err:.3e} of the peak "
          f"({'the same bits' if err == 0 else 'not the same bits'}; tol {GRAPH_TOL:g}); ms a "
          f"frame fused {f['median_ms']:.3f} (median of {f['per_frame_ms']}), int8 head "
          f"{i['median_ms']:.3f} (median of {i['per_frame_ms']}); device time a frame of a "
          f"replayed 17-frame window fused {device['fused']['median_ms']:.3f} (median of "
          f"{device['fused']['per_frame_ms']}), int8 head {device['int8 head']['median_ms']:.3f} "
          f"(median of {device['int8 head']['per_frame_ms']}); launches fused "
          f"{f['launches']}, int8 head {i['launches']}", flush=True)
    if not same_tokens or not err <= GRAPH_TOL:
        fail("int8 head: the graphed run differs from the eager one")
    if i["launches"]["fused_head_ffn_stack"] or i["launches"]["fused_stage_step"]:
        fail(f"int8 head: C or D launched on the unfused path: {i['launches']}")

    # the profile of one graphed window
    out_dir = SURFACE_ROOT / "trace"
    names = ("vv.prompt", "vv.window")
    with profiling.trace(str(out_dir)) as prof:
        with profiling.phase(names[0]):
            p = model["processor"](text=model["script"], voice_samples=[model["voices"]])
        with profiling.phase(names[1]):
            _timed_generate(cfg, q8, p, toks, seed, opts, short)
    events = prof.events()
    found = {n for n in names if any(e.name == n for e in events)}
    trace_text = (out_dir / "trace.json").read_text()
    in_trace = {n for n in names if json_.dumps(n) in trace_text}
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    print(f"  profiling.trace around one graphed window: phases {sorted(found)} among the "
          f"events, {sorted(in_trace)} in {out_dir.relative_to(ROOT)}/trace.json "
          f"({len(trace_text)} bytes), device time {device_us / 1e3:.3f} ms", flush=True)
    if found != set(names) or in_trace != set(names):
        fail(f"profiling: phases {names} not all found ({found}, {in_trace})")
    del q8, fn
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for r in rec.values():
        r.pop("audio")
        r.pop("sequences")
    return dict(graphed_vs_eager=err, runs=rec, device=device, launches=i["launches"],
                trace_bytes=len(trace_text), trace_device_ms=device_us / 1e3)


def thresholding_card_vs_cpu(seed: int) -> dict:
    """Phase 14 (d): dpm_solver.sample with dynamic thresholding (ratio 0.9,
    cap 2.5) over a toy model whose x0 estimates pass 1, for dpmsolver++
    and sde-dpmsolver++ (injected noise), 10 steps, a (4, 64) f32 state:
    the card against the CPU on the same inputs within THRESHOLD_TOL."""
    import numpy as np
    import torch

    from vibevoice_tpu_torch.schedule import dpm_solver as dpm

    rng = np.random.RandomState(seed + 14)
    w = torch.from_numpy(rng.randn(64, 64).astype(np.float32))
    x0 = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    noise = torch.from_numpy(rng.randn(10, 4, 64).astype(np.float32))
    errs = {}
    for algo in ("dpmsolver++", "sde-dpmsolver++"):
        coeffs = dpm.make_solver(10, algorithm_type=algo)
        outs = []
        for dev in ("cuda", "cpu"):
            wd = w.to(dev)
            head = lambda x, t: 3.0 * torch.tanh(x @ wd) * (t[:, None] / 1000 + 0.5)
            outs.append(dpm.sample(coeffs, head, x0.to(dev), noise=noise.to(dev),
                                   thresholding=True, dynamic_thresholding_ratio=0.9,
                                   sample_max_value=2.5).cpu())
        errs[algo] = float((outs[0] - outs[1]).abs().max() / outs[1].abs().max())
    print(f"  sample(thresholding=True) card against CPU: {errs} of the peak "
          f"(tol {THRESHOLD_TOL:g})", flush=True)
    if not all(e <= THRESHOLD_TOL for e in errs.values()):
        fail("sample(thresholding=True): the card disagrees with the CPU")
    return errs


def dots_end_to_end(seed: int) -> dict:
    """Phase 14 (e): the 1.5B QLoRA trainer, B2 T2048, 3 steps, with
    --remat and with --remat --remat_policy dots (which writes its
    checkpoint under build/phase14/trained for (f)): each step's loss
    within DOTS_LOSS_TOL of the other run's, peak GiB and s/step of both."""
    recs = finetune_end_to_end(seed, CONFIG_1P5B, FINETUNE_RUNS_DOTS)
    (la, a), (lb, b) = recs.items()
    rel = max(abs(x["loss"] - y["loss"]) / abs(x["loss"]) for x, y in zip(a["steps"], b["steps"]))
    print(f"  {lb} against {la}: losses {[s['loss'] for s in b['steps']]} against "
          f"{[s['loss'] for s in a['steps']]} (max relative difference {rel:.3e}, tol "
          f"{DOTS_LOSS_TOL:g}); peak {b['peak_gib']:.2f} against {a['peak_gib']:.2f} GiB, "
          f"{b['seconds_per_step']:.3f} against {a['seconds_per_step']:.3f} s/step", flush=True)
    if not rel <= DOTS_LOSS_TOL:
        fail(f"remat_policy dots: losses {rel:.3e} from full remat's")
    return dict(runs=recs, loss_rel_diff=rel)


def scripts_end_to_end(ckpt: Path) -> dict:
    """Phase 14 (f): scripts/merge_vibevoice_models on phase 11's 1.5B
    checkpoint (bf16 shards without tokenizer files, read at f32 with the
    fallback tokenizer) with the adapters of (e)'s dots
    run (lora_adapters.pkl; r 16 on the seven LM targets and the head):
    the verification (merged = base + scaling * A @ B, changed, the
    parameter count) passes on the card and the native f32 tree is
    written; then scripts/qa_real_checkpoint on the same checkpoint at f32
    (convert, parity, a short generate, the forced rtf bench through the
    graphed 8-frame step): exit 0 and a report with the JAX harness's keys.
    The card's machine has transformers but not the upstream vibevoice
    package, so parity is skipped with its reason: the report says so, and
    that is not a pass."""
    import json as json_

    import torch

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.scripts import merge_vibevoice_models as merge
    from vibevoice_tpu_torch.scripts import qa_real_checkpoint as qa

    rec = {}
    os.environ["VIBEVOICE_ALLOW_FALLBACK_TOKENIZER"] = "1"  # random weights, no tokenizer
    trained = sorted((SURFACE_ROOT / "trained").glob("checkpoint-*"))
    if not trained:
        fail("no trainer checkpoint under build/phase14/trained")
    out = SURFACE_ROOT / "merged"
    t0 = time.perf_counter()
    report = merge.main(["--base_model", str(ckpt), "--trained_checkpoint", str(trained[-1]),
                         "--output_dir", str(out)])
    rec["merge"] = dict(report, wall_s=time.perf_counter() - t0,
                        bytes=(out / "params.pkl").stat().st_size)
    print(f"  merge_vibevoice_models: {report}, params.pkl {rec['merge']['bytes']} bytes, "
          f"{rec['merge']['wall_s']:.1f} s", flush=True)
    if (report["lm_changed"] + report["lm_unchanged"] != 28 * 7 or not report["lm_changed"]
            or report["head_changed"] + report["head_unchanged"] != 4 * 3):
        fail(f"merge: {report}")
    torch.cuda.empty_cache()
    path = SURFACE_ROOT / "qa_report.json"
    t0 = time.perf_counter()
    rc = qa.main([str(ckpt), "--allow_fallback_tokenizer", "--report", str(path)])
    rep = json_.loads(path.read_text())
    rec["qa"] = dict(rep, wall_s=time.perf_counter() - t0)
    keys = {"checkpoint", "dtype", "convert_seconds", "parity", "generate", "rtf", "ok"}
    note = rep["parity"]["skipped"] if isinstance(rep["parity"], dict) else None
    print(f"  qa_real_checkpoint: exit {rc}, keys {sorted(rep)}, convert "
          f"{rep['convert_seconds']} s, generate {rep['generate']}, rtf {rep['rtf']}; parity: "
          + (f"skipped (not a pass): {note}" if note else f"{rep['parity']}"), flush=True)
    if rc != 0 or set(rep) != keys or rep["rtf"]["frames"] != 32 or not rep["rtf"]["audio_seconds"]:
        fail(f"qa_real_checkpoint: exit {rc}, report {rep}")
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def surface_7b(model: dict, seed: int, frames: int = 8) -> dict:
    """Phase 12 (g): the 7B's surface shapes on a main path: phase 12's
    model with its int8 LM packed (pack_lm_projections) and an int8 head
    (the 7B's 3584-10752-3584 head drawn alone from --seed and quantized by
    quantize_diffusion_head, unfused) beside the fused vocoder: one forced
    `frames`-frame generate() through the eager step at 4,096 slots, whose
    kernel A launches the "@pack@7b" and "@head@7b" entries count."""
    import dataclasses

    import numpy as np
    import torch

    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.ops import quant
    from vibevoice_tpu_torch.utils.params import init

    cfg, toks = model["cfg"], model["toks"]
    head_cfg = dataclasses.replace(tiny_config(), diffusion_head_config=cfg.diffusion_head_config)
    head = init(head_cfg, seed=seed, dtype=torch.bfloat16)["diffusion_head"]
    params = {**model["params"], "lm": quant.pack_lm_projections(model["params"]["lm"]),
              "diffusion_head": quant.quantize_diffusion_head(head)}
    proc = model["processor"](text=model["script"], voice_samples=[model["voices"]])
    forced, _ = forced_scripts(toks, frames)
    opts = inf.GenerateOptions(ddpm_steps=10, cfg_scale=1.3, max_length=4096,
                               frames_per_dispatch=4)
    fn = inf.make_multi_step_fn(cfg, toks, opts, 4, inject=True)
    reset_counts(("int8_matmul",))
    out, wall = _timed_generate(cfg, params, proc, toks, seed, opts, forced, fn.eager)
    counts = read_counts(("int8_matmul",))
    audio = out.speech_outputs[0]
    print(f"  the 7B packed with an int8 head: a forced {frames}-frame eager generate() in "
          f"{wall:.3f} s, A's GEMV launches {counts}", flush=True)
    if audio is None or not np.isfinite(audio).all() or not counts["int8_matmul"] > 0:
        fail("the 7B packed with an int8 head: no audio or no launches")
    del params, head
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall_s=wall, launches=counts)


def surface_checkpoint(seed: int) -> Path:
    """Phase 11's 1.5B checkpoint written again by phase 11's code (the
    dense bf16 weights of utils.params.init at --seed as reference-layout
    safetensors shards, no tokenizer files: the same bytes), under
    build/phase14, for (f)'s scripts."""
    import torch

    from vibevoice_tpu_torch.configs import VibeVoiceConfig
    from vibevoice_tpu_torch.utils.params import init

    path = SURFACE_ROOT / "vibevoice-1.5b"
    t0 = time.perf_counter()
    dense = init(VibeVoiceConfig.from_json_file(str(CONFIG_1P5B)), seed=seed,
                 dtype=torch.bfloat16)
    nbytes = write_checkpoint(path, reference_state_dict(dense), CONFIG_1P5B)
    del dense
    torch.cuda.empty_cache()
    print(f"  phase 11's 1.5B checkpoint written again: {nbytes} bytes in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return path


def the_surface(checks: Checks, seed: int, frames: int) -> dict:
    """Phase 14: (a) check_surface_kernels, (b) lm_pack_end_to_end, (c)
    small_int8_card_vs_cpu and int8_head_end_to_end (with the profiling
    trace), (d) thresholding_card_vs_cpu, (e) dots_end_to_end, (f)
    scripts_end_to_end on surface_checkpoint's. The "@pack", "@head" and
    "@tok" entries count kernel A's launches in (b)'s packed runs and (c)'s
    int8-head runs (all of A's launches there, the LM's among them)."""
    import shutil

    import torch

    t0 = time.perf_counter()
    walls, runs = {}, {}
    check_surface_kernels(checks, seed)
    walls["kernels"] = time.perf_counter() - t0
    t = time.perf_counter()
    model = serving_model(seed)
    runs["lm_pack"] = lm_pack_end_to_end(model, seed, frames)
    checks.kernels["int8_matmul@pack"]["launches"] += runs["lm_pack"]["launches"]["int8_matmul"]
    walls["lm_pack"] = time.perf_counter() - t
    t = time.perf_counter()
    runs["small_int8"] = small_int8_card_vs_cpu(seed)
    runs["int8_head"] = int8_head_end_to_end(model, seed, frames)
    launches = runs["int8_head"]["launches"]
    for name in ("int8_matmul@head", "int8_matmul@tok"):
        checks.kernels[name]["launches"] += launches["int8_matmul"]
    checks.kernels["int8_matmul_gemm@tok"]["launches"] += launches["int8_matmul_gemm"]
    walls["int8_head"] = time.perf_counter() - t
    del model
    gc.collect()
    torch.cuda.empty_cache()
    runs["thresholding"] = thresholding_card_vs_cpu(seed)
    t = time.perf_counter()
    try:
        runs["dots"] = dots_end_to_end(seed)
        for rec in runs["dots"]["runs"].values():
            for name, n in rec["launches"].items():
                checks.kernels[name]["launches"] += n
        walls["dots"] = time.perf_counter() - t
        t = time.perf_counter()
        runs["scripts"] = scripts_end_to_end(surface_checkpoint(seed))
        walls["scripts"] = time.perf_counter() - t
    finally:
        shutil.rmtree(SURFACE_ROOT, ignore_errors=True)
    walls["phase"] = time.perf_counter() - t0
    print("  phase 14 walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()),
          flush=True)
    return dict(runs=runs, walls=walls)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=32, help="forced frames per generate() run")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()

    if not (ROOT / "vibevoice_tpu_torch" / "csrc").is_dir():
        fail(f"no vibevoice_tpu_torch/csrc beside {Path(__file__).name}: run from a checkout")
    # Kineto tears CUPTI down after each profile and sets it up again at the
    # next; with CUDA graphs alive that re-init now and then records no
    # device activity for the rest of the process (torch.profiler sets these
    # two itself only for torch.compile's graphs). This script profiles tens
    # of times beside captured graphs, so CUPTI stays set up.
    cupti_env = {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}
    if (os.environ.get("PYTHONHASHSEED") != "0"  # Python salts str hashes per process
            or any(os.environ.get(k) != v for k, v in cupti_env.items())):
        os.environ.update(PYTHONHASHSEED="0", **cupti_env)
        os.execv(sys.executable, [sys.executable, *sys.orig_argv[1:]])
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.library()
    print(f"build: {lib.path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s "
          f"(parallel nvcc {lib.build_seconds:.1f} s)", flush=True)
    spills = [ln.strip() for ln in lib.build_log.splitlines()
              if re.search(r"[1-9][0-9]* bytes spill", ln)]
    print(f"  ptxas: {len(spills)} kernel(s) spill registers" + "".join(f"\n    {ln}" for ln in spills))
    print("  ptxas, the training attention's tensor-core kernels:"
          + "".join(f"\n    {ln}" for ln in ptxas_report(lib.build_log, "flash_train_")))

    # phase 3: kernels against their plain versions
    checks = Checks()
    sources = {
        "int8_matmul": ("vibevoice_tpu_torch/csrc/int8_matmul.cu", "vibevoice_tpu/ops/quant.py:129"),
        "int8_matmul_gemm": ("vibevoice_tpu_torch/csrc/int8_gemm.cu",
                             "vibevoice_tpu/ops/quant.py:129"),
        "flash_cached_attention": ("vibevoice_tpu_torch/csrc/flash_decode.cu",
                                   "vibevoice_tpu/ops/flash_attention.py:71"),
        "flash_cached_attention_prefill": ("vibevoice_tpu_torch/csrc/flash_prefill.cu",
                                           "vibevoice_tpu/ops/flash_attention.py:71"),
        "fused_head_ffn_stack": ("vibevoice_tpu_torch/csrc/head_ffn.cu",
                                 "vibevoice_tpu/ops/head_fused.py:144"),
        "fused_stage_step": ("vibevoice_tpu_torch/csrc/vocoder_stage.cu",
                             "vibevoice_tpu/ops/vocoder_fused.py:202"),
        "int8_matmul_t": ("vibevoice_tpu_torch/csrc/int8_matmul_t.cu",
                          "vibevoice_tpu/ops/quant.py:220"),
        # JAX's bundled Pallas TPU flash attention (forward; dK/dV and dQ
        # backward kernels), called at this line
        "flash_train_attention_fwd": ("vibevoice_tpu_torch/csrc/flash_train.cu",
                                      "vibevoice_tpu/models/qwen2.py:284"),
        "flash_train_attention_bwd": ("vibevoice_tpu_torch/csrc/flash_train.cu",
                                      "vibevoice_tpu/models/qwen2.py:284"),
        "flash_ring_block": ("vibevoice_tpu_torch/csrc/flash_ring.cu",
                             "vibevoice_tpu/ops/flash_attention.py:311"),
    }
    tp_entries = ("flash_cached_attention", "flash_cached_attention_prefill",
                  "flash_train_attention_fwd", "flash_train_attention_bwd")
    # the 1.5B's and 0.5B's shapes (phases 3-11), the 7B's (phase 12), the
    # local heads of tensor-parallel ranks (phase 13)
    # kernel A at the surface's shapes (phase 14 and, "@7b", phase 12)
    entries = [n + tag for tag in ("", "@7b", "@tp") for n in sources
               if tag != "@tp" or n in tp_entries] + list(SURFACE_ENTRIES)
    for entry in entries:
        src, rep = sources[entry.split("@")[0]]
        checks.kernels[entry] = dict(name=entry, route="cuda", source=src, replaces=rep,
                                     launches=0, max_abs_err=0.0, ms=None, plain_ms=None,
                                     bound_ms=None, bound_by=None, library_ms=None)
    check_kernels(checks, args.seed)
    check_streaming_attention(checks, args.seed)
    check_batched_kernels(checks, args.seed)
    check_ring_kernel(checks, args.seed)
    check_training_kernels(checks, args.seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # phase 4: end to end, serving
    print("end to end: serving", flush=True)
    tiny_card_vs_cpu(args.seed)
    model = serving_model(args.seed)
    e2e = end_to_end(model, args.seed, args.frames)
    for name, n in e2e["launches"].items():
        checks.kernels[name]["launches"] += n
    runs = {"serving": e2e["runs"], "serving_unforced": unforced_end_to_end(model, args.seed),
            "graphed_profile": graphed_profile(model, args.seed)}
    torch.cuda.empty_cache()

    # phase 5: end to end, sequence-parallel prefill
    print("end to end: sequence-parallel (ring-attention) prefill", flush=True)
    sp = sp_prefill_end_to_end(model, args.seed)
    for name, n in sp["launches"].items():
        checks.kernels[name]["launches"] += n
    runs["sp_prefill"] = sp["runs"]
    del model

    inf._captures.clear()  # the captured graphs and their static carries
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6: end to end, the streaming 0.5B model
    print("end to end: streaming 0.5B", flush=True)
    stream_model = streaming_model(args.seed)
    stream = streaming_end_to_end(stream_model, args.seed)
    for name, n in stream["launches"].items():
        checks.kernels[name]["launches"] += n
    runs["streaming"] = {**stream["runs"], "preset_build": stream_model["preset_build"]}
    del stream_model
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 7: end to end, fine-tuning
    print("end to end: fine-tuning", flush=True)
    tiny_qlora_card_vs_cpu(args.seed)
    runs["finetune"] = finetune_end_to_end(args.seed)
    for rec in runs["finetune"].values():
        for name, n in rec["launches"].items():
            checks.kernels[name]["launches"] += n

    # phase 8: end to end, the continuous-batching serving engine (1.5B)
    print("end to end: the serving engine (1.5B, batched slots)", flush=True)
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()
    model = serving_model(args.seed)
    served = serving_engine_end_to_end(model, args.seed)
    for name, n in served["launches"].items():
        checks.kernels[name]["launches"] += n
    runs["serving_engine"] = served["runs"]

    # phase 9: end to end, the multi-session engine (0.5B)
    print("end to end: the session engine (0.5B, batched sessions)", flush=True)
    stream_model = streaming_model(args.seed)
    sessions = session_engine_end_to_end(stream_model, args.seed)
    for name, n in sessions["launches"].items():
        checks.kernels[name]["launches"] += n
    runs["session_engine"] = sessions["runs"]

    # phase 10: end to end, the HTTP server over both engines
    print("end to end: the HTTP server", flush=True)
    runs["http"] = http_end_to_end(served["engine"], model["processor"], sessions["engine"],
                                   sessions["params"])
    served["engine"].shutdown()
    sessions["engine"].shutdown(drain=False)
    del model, served, sessions, stream_model
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 11: end to end from checkpoints
    print("end to end: from checkpoints (1.5B and 0.5B, the two file CLIs)", flush=True)
    ckpt = checkpoint_end_to_end(args.seed, args.frames, e2e["reference"])
    for name, n in ckpt["launches"].items():
        checks.kernels[name]["launches"] += n
    runs["checkpoints"] = ckpt["runs"]
    del e2e
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 12: the 7B at full width
    print("the 7B (qwen2.5_7b_32k.json): kernels at its shapes, serving, long-form prefill, the "
          "serving engine, QLoRA, a checkpoint", flush=True)
    runs["7b"] = the_7b(checks, args.seed, args.frames)
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 13: tensor parallelism on one card
    print("tensor parallelism (the 7B at tp 1 over NCCL and tp 2 over gloo on the one card, the "
          "trainer at tp 2 and dp 2)", flush=True)
    runs["tp"] = tensor_parallel(checks, args.seed, args.frames)
    inf._captures.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # phase 14: the rest of the JAX package's surface
    print("the surface: kernel A at the packed, int8-head and int8-tokenizer shapes, LM_PACK=1, "
          "the int8 head and tokenizers, thresholding, remat_policy dots, the merge and QA "
          "scripts, profiling", flush=True)
    runs["surface"] = the_surface(checks, args.seed, args.frames)

    unmeasured = [k["name"] for k in checks.kernels.values() if k["ms"] is None or k["launches"] == 0]
    if unmeasured:
        fail(f"kernels without a timed main-path case or a main-path launch: {unmeasured}")
    result = {"kernels": list(checks.kernels.values())}
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "chip_smoke.json").write_text(
            json.dumps({**result, "card": card, "end_to_end": runs, "cases": checks.cases,
                        **checks.extra}, indent=1))
        (Path(args.out) / "kernel_build.log").write_text(lib.build_log)
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s of wall (this process, after the "
          f"re-exec)", flush=True)
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
