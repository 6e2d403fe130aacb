"""HTTP TTS server on the port's serving engines (port of demo/serve.py).

A standard-library (``http.server``) front end: concurrent POSTs are batched
into one compiled decode on the card by ``ServingEngine``; ``/tts/rt`` serves
the streaming 0.5B model, through ``StreamingSessionEngine`` with
``--rt_sessions`` > 1 or one stream at a time through ``StreamingTTS``.

  POST /tts         {"text": "Speaker 1: ...", "speaker_names"?: ["Alice"],
                     "seed"?, "deadline_s"?, "priority"?} -> audio/wav (whole file)
  POST /tts/stream  the same body -> chunked audio/wav: the header at once,
                    PCM chunks as the engine produces frames
  POST /tts/rt      {"text": "...", "seed"?, "priority"?} -> chunked audio/wav
                    from the streaming model. With --rt_sessions > 1,
                    {"live": true} opens a LIVE session: the text stream stays
                    open, the response carries X-Session-Id, and more text
                    arrives on another connection through
  POST /tts/rt/append  {"session": sid, "text": "..."} (a session parked on
                    EOS resumes) and
  POST /tts/rt/end  {"session": sid} (the session ends at its next EOS).
                    A live session parked for text waits for it without a
                    bound; --request_timeout bounds the wait for each frame
                    while it speaks.
  POST /v1/audio/speech
                    OpenAI-shaped: {"model": ignored, "input": "...", "voice"?,
                    "response_format"?: "wav" | "pcm", "seed"?} -> audio/wav or
                    raw 24 kHz s16le PCM; bare text gets the "Speaker 1:"
                    prefix; errors come back as {"error": {...}}.
  GET  /health      -> {"status": "ok", "active": N}
  GET  /stats       -> EngineStats JSON (+ "rt_sessions": the session engine's)

Usage (on the card; --device cpu runs the plain versions of the kernels):

  python -m vibevoice_tpu_torch.serving.server --model_path <ckpt> --int8 \\
      --streaming_model_path <ckpt-0.5b> --streaming_voice voice.npz --rt_sessions 8 --warmup
  python -m vibevoice_tpu_torch.serving.server --config 1.5b --streaming_config 0.5b \\
      --rt_sessions 8 --warmup
  python -m vibevoice_tpu_torch.serving.server --smoke --device cpu

``--model_path`` / ``--streaming_model_path`` load checkpoint directories
(tts.VibeVoiceTTS / StreamingTTS.from_pretrained; the streaming model needs
``--streaming_voice``, a .npz or the reference's .pt preset); ``--int8``
quantizes the LM and lm_head and packs the serving stacks for kernels C and
D (and the streaming vocoder for D), as the random-weight models are served.
``--config 1.5b`` / ``--streaming_config 0.5b`` (or a config JSON) serve the
full-width models with random weights from ``--seed``; ``--smoke`` the tiny
ones.

Tensor-parallel serving of the multi-speaker model (``--tp N``, as the JAX
server's): the command starts N processes on this host, one a rank; rank 0
serves HTTP on ``cuda:0`` and ranks 1..N-1 follow on ``cuda:1``..``cuda:N-1``
(``--device cpu``: all on the CPU). Each builds the model (dense LM: the
random-weight models keep theirs dense, and ``--int8`` is refused) and runs
its shard in ``ServingEngine(mesh=)``: over NCCL on the card, whose windows
replay CUDA graphs with their all-reduces, over gloo on the CPU::

  python -m vibevoice_tpu_torch.serving.server --config <7B json> --tp 2 --warmup
  python -m vibevoice_tpu_torch.serving.server --smoke --tp 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import struct
import uuid
from pathlib import Path

import numpy as np

SAMPLE_RATE = 24_000
CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CONFIG_ALIASES = {"1.5b": CONFIGS / "qwen2.5_1.5b_64k.json",
                  "0.5b": CONFIGS / "qwen2.5_0.5b_streaming.json"}
VOICES_DIR = Path(__file__).resolve().parents[2] / "demo" / "voices"
# the unknown-length convention of live WAV streams (RIFF and data sizes)
STREAM_WAV_HEADER = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
                     + struct.pack("<IHHIIHH", 16, 1, 1, SAMPLE_RATE, SAMPLE_RATE * 2, 2, 16)
                     + b"data" + struct.pack("<I", 0xFFFFFFFF))


def wav_header(sample_rate: int, num_samples: int) -> bytes:
    """Standard 16-bit mono PCM WAV header."""
    data_size = num_samples * 2
    return (b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", data_size))


def pcm16(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


class VoiceMapper:
    """Speaker names to the voice files of a directory: 'en-Carter_man.wav'
    answers to 'Carter' (and to any name containing it)."""

    def __init__(self, voices_dir):
        self.voice_presets = {}
        if os.path.isdir(voices_dir):
            for f in sorted(os.listdir(voices_dir)):
                if not f.lower().endswith((".wav", ".mp3", ".flac", ".ogg", ".m4a")):
                    continue
                name = os.path.splitext(f)[0]
                if "-" in name:  # strip the language prefix and the gender suffix
                    name = name.split("-", 1)[1]
                self.voice_presets[name.split("_")[0]] = os.path.join(voices_dir, f)

    def get_voice_path(self, speaker_name: str) -> str:
        if speaker_name in self.voice_presets:
            return self.voice_presets[speaker_name]
        for k, v in self.voice_presets.items():
            if k.lower() in speaker_name.lower() or speaker_name.lower() in k.lower():
                return v
        if self.voice_presets:
            return self.voice_presets[sorted(self.voice_presets)[0]]
        raise ValueError(f"No voice presets available for speaker '{speaker_name}'")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    model = ap.add_argument_group("models")
    model.add_argument("--config", default=None,
                       help="'1.5b' or a config JSON: that configuration at full width with "
                            "random weights from --seed")
    model.add_argument("--smoke", action="store_true",
                       help="the tiny random-weight models (and /tts/rt on the tiny 0.5B)")
    model.add_argument("--model_path", default=None,
                       help="a multi-speaker checkpoint directory (HF-style or native)")
    model.add_argument("--int8", action="store_true",
                       help="with checkpoints: int8 LM + lm_head and the serving packs of "
                            "kernels C and D (the random-weight models are always served so)")
    model.add_argument("--streaming_config", default=None,
                       help="'0.5b' or a config JSON: serve /tts/rt on that streaming "
                            "configuration with random weights")
    model.add_argument("--streaming_model_path", default=None,
                       help="a streaming checkpoint directory: serve /tts/rt on it")
    model.add_argument("--streaming_voice", default=None,
                       help="the voice preset of --streaming_model_path (.npz or the "
                            "reference's .pt)")
    model.add_argument("--seed", type=int, default=0)
    model.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a card) or cpu (the plain versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--reserved_slots", type=int, default=0,
                    help="express slots only priority=true requests may occupy")
    ap.add_argument("--max_len", type=int, default=4096)
    ap.add_argument("--cfg_scale", type=float, default=1.3)
    ap.add_argument("--ddpm_steps", type=int, default=10)
    ap.add_argument("--frames_per_dispatch", type=int, default=4,
                    help="frames a window (one graph replay); audio arrives in K-frame chunks")
    ap.add_argument("--no_pipeline", action="store_true",
                    help="deliver each window before enqueuing the next")
    ap.add_argument("--kv_int8", action=argparse.BooleanOptionalAction, default=None,
                    help="int8 KV cache; default: on from --max_len 16384")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks of the multi-speaker model (one process and one "
                         "card each, started by this command); the LM must be dense")
    ap.add_argument("--voices_dir", default=str(VOICES_DIR))
    ap.add_argument("--streaming_max_len", type=int, default=8192)
    ap.add_argument("--streaming_ddpm_steps", type=int, default=5)
    ap.add_argument("--rt_sessions", type=int, default=1,
                    help="concurrent /tts/rt sessions batched in one StreamingSessionEngine "
                         "(> 1; 1 serves one stream at a time)")
    ap.add_argument("--rt_quantum", type=int, default=3,
                    help="session admission quantum in frames (a divisor of 6)")
    ap.add_argument("--rt_reserved_slots", type=int, default=0)
    ap.add_argument("--warmup", action="store_true",
                    help="capture the serving graphs before the first request")
    ap.add_argument("--warmup_tokens", type=int, default=256)
    ap.add_argument("--request_timeout", type=float, default=600.0)
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def _config(name: str) -> str:
    return str(CONFIG_ALIASES.get(name.lower(), name))


def _build_tts(args, device):
    """The multi-speaker model for the options (dense LM under --tp)."""
    from ..models import vibevoice as vv
    from ..tts import VibeVoiceTTS

    if args.smoke:
        return VibeVoiceTTS.smoke(device=device)
    if args.model_path:
        if args.int8 and args.tp > 1:
            raise SystemExit("--tp shards a dense LM: drop --int8 (the int8 LM is the "
                             "one-device memory configuration)")
        tts = VibeVoiceTTS.from_pretrained(args.model_path, int8=args.int8, device=device)
        if args.int8:
            tts.params = vv.fuse_for_serving(tts.params, tts.cfg, quantize=True)
        return tts
    if args.config:
        return VibeVoiceTTS.random(_config(args.config), seed=args.seed, device=device,
                                   int8_lm=args.tp == 1)
    raise SystemExit("give --model_path (a checkpoint), --config 1.5b (random full-width "
                     "weights) or --smoke (the tiny models)")


def _build_models(args):
    """(tts, rt) for the options: a VibeVoiceTTS and a StreamingTTS or None."""
    from ..models import streaming as st
    from ..tts import StreamingTTS

    tts = _build_tts(args, args.device)
    if args.smoke:
        return tts, StreamingTTS.smoke(max_len=args.streaming_max_len, device=args.device)
    rt = None
    if args.streaming_model_path:
        rt = StreamingTTS.from_pretrained(args.streaming_model_path, voice=args.streaming_voice,
                                          max_len=args.streaming_max_len, device=args.device)
        if args.int8:
            rt.params = st.fuse_vocoder(rt.params, rt.cfg, quantize=True)
    elif args.streaming_config:
        rt = StreamingTTS.random(_config(args.streaming_config), seed=args.seed,
                                 max_len=args.streaming_max_len, device=args.device)
    return tts, rt


def _engine(args, tts, mesh=None):
    from ..models import inference as inf
    from .engine import ServingEngine

    return ServingEngine(
        tts.cfg, tts.params, tokens=tts.tokens,
        opts=inf.GenerateOptions(cfg_scale=args.cfg_scale, ddpm_steps=args.ddpm_steps,
                                 max_length=args.max_len, kv_int8=args.kv_int8),
        max_batch=args.max_batch, max_len=args.max_len,
        frames_per_dispatch=args.frames_per_dispatch, pipeline=not args.no_pipeline,
        reserved_slots=args.reserved_slots, mesh=mesh)


def _join_tp(args, rank: int, port: int):
    """This process as rank ``rank`` of --tp: its device, the process group
    and the mesh."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    device = args.device
    if device != "cpu":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=args.tp)
    return device, make_mesh(dp=1, tp=args.tp)


def _follow(args, rank: int, port: int) -> None:
    """Rank ``rank`` > 0 of --tp: its shard of the engine, until rank 0 stops."""
    import torch.distributed as dist

    device, mesh = _join_tp(args, rank, port)
    engine = _engine(args, _build_tts(args, device), mesh)
    engine.shutdown()  # waits for rank 0's
    dist.destroy_process_group()


def build_server(args, *, engine=None, processor=None, rt=None, rt_engine=None, mesh=None):
    """The HTTP server (not yet serving: call serve_forever) over engines
    built from ``args`` (``parse_args``), or over the ones given: a
    ServingEngine and the processor of its model, and for /tts/rt a
    StreamingTTS (``rt``) or a StreamingSessionEngine (``rt_engine``).
    ``mesh``: rank 0's mesh under --tp (``main`` joins the ranks)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..models import inference as inf
    from .engine import Request
    from .streaming_sessions import StreamingSessionEngine

    if engine is None:
        tts, built_rt = _build_models(args)
        processor = tts.processor
        rt = rt or built_rt
        engine = _engine(args, tts, mesh)
        if args.warmup:
            print(f"[serve] warmup: {engine.warmup(prompt_tokens=args.warmup_tokens):.1f} s")
        if rt is not None and args.rt_sessions > 1:
            rt_engine = StreamingSessionEngine(
                rt.cfg, rt.params, n_slots=args.rt_sessions, max_len=args.streaming_max_len,
                opts=inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=args.streaming_ddpm_steps),
                default_preset=rt.preset, processor=rt.processor, quantum=args.rt_quantum,
                reserved_slots=args.rt_reserved_slots, seed=args.seed)
        if rt is not None and args.warmup:
            if rt_engine is not None:
                rt_engine.warmup(timeout=args.request_timeout)
            else:
                rt.warmup(ddpm_steps=args.streaming_ddpm_steps)
    if processor is None:
        raise ValueError("build_server(engine=...) needs the processor of the engine's model")
    live_rt = {}  # sid -> live StreamSessionHandle (X-Session-Id)
    request_timeout = args.request_timeout
    voices_dir = args.voices_dir
    verbose = getattr(args, "verbose", False)
    rt_ddpm_steps = getattr(args, "streaming_ddpm_steps", 5)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

        def log_message(self, fmt, *a):
            if verbose:
                super().log_message(fmt, *a)

        def _send(self, status: int, ctype: str, body: bytes):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, payload):
            self._send(status, "application/json", json.dumps(payload).encode())

        def _json_error(self, status: int, message: str):
            """OpenAI-shaped error body ({"error": {...}})."""
            self._json(status, {"error": {"message": message, "type": "invalid_request_error"}})

        def _error(self, openai: bool, status: int, message: str):
            if openai:
                self._json_error(status, message)
            else:
                self.send_error(status, message)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok",
                                 "active": sum(h is not None for h in engine.slots)})
            elif self.path == "/stats":
                payload = dataclasses.asdict(engine.stats())
                if rt_engine is not None:
                    payload["rt_sessions"] = rt_engine.stats()
                self._json(200, payload)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path in ("/tts/rt/append", "/tts/rt/end"):
                self._rt_live_control()
                return
            if self.path not in ("/tts", "/tts/stream", "/tts/rt", "/v1/audio/speech"):
                self.send_error(404)
                return
            openai = self.path == "/v1/audio/speech"
            response_format = "wav"
            try:
                req = self._body()
                if openai:
                    text = str(req["input"])
                    if not re.search(r"(?m)^\s*(Speaker\s+\d+|\[\d+\])\s*:", text):
                        text = f"Speaker 1: {text}"
                    response_format = str(req.get("response_format", "wav")).lower()
                    if response_format not in ("wav", "pcm"):
                        self._json_error(400, f"response_format {response_format!r} not "
                                              "supported (this server emits 'wav' or raw 24 kHz "
                                              "s16le 'pcm')")
                        return
                    if req.get("voice"):
                        req["speaker_names"] = [str(req["voice"])]
                else:
                    text = req["text"]
                seed = int(req.get("seed", 0))
                # presence, not truth: deadline_s=0 means expired at submit
                deadline_s = float(req["deadline_s"]) if "deadline_s" in req else None
                priority = bool(req.get("priority", False))
                live = bool(req.get("live", False))
            except Exception as e:
                self._error(openai, 400, f"bad request: {e}")
                return

            if self.path == "/tts/rt":
                if rt is None and rt_engine is None:
                    self.send_error(404, "server started without a streaming model")
                elif live and rt_engine is None:
                    self.send_error(400, "live sessions need --rt_sessions > 1")
                else:
                    self._rt_response(text, seed, priority, live)
                return

            try:
                voice_samples = None
                if req.get("speaker_names"):
                    mapper = VoiceMapper(voices_dir)
                    voice_samples = [[mapper.get_voice_path(n) for n in req["speaker_names"]]]
                proc = processor(text=text, voice_samples=voice_samples)
            except Exception as e:
                self._error(openai, 400, f"processing failed: {e}")
                return
            handle = engine.submit(Request(
                input_ids=proc.input_ids, valid_mask=proc.attention_mask,
                speech_tensors=proc.speech_tensors, speech_frame_valid=proc.speech_masks,
                speech_input_mask=proc.speech_input_mask, seed=seed, deadline_s=deadline_s,
                priority=priority))
            if self.path == "/tts/stream":
                self._stream(handle.stream(), handle.cancel,
                             lambda: handle.error)
                return
            try:
                audio = handle.result(timeout=request_timeout)
            except Exception as e:
                self._error(openai, 500, f"generation failed: {e}")
                return
            pcm = pcm16(audio)
            if openai and response_format == "pcm":
                self._send(200, "audio/pcm", pcm)  # raw s16le samples, no container
            else:
                self._send(200, "audio/wav", wav_header(SAMPLE_RATE, len(pcm) // 2) + pcm)

        def _rt_live_control(self):
            """/tts/rt/append {"session", "text"} and /tts/rt/end {"session"}:
            the side channel of a live session (its audio rides the /tts/rt
            response whose X-Session-Id names it). The text is tokenized as
            it comes: the client owns the segmentation of its text stream."""
            try:
                req = self._body()
                sid = str(req["session"])
            except Exception as e:
                self._json_error(400, f"bad request: {e}")
                return
            h = live_rt.get(sid)
            if h is None:
                self._json_error(404, f"unknown or ended live session {sid!r}")
                return
            try:
                if self.path == "/tts/rt/append":
                    ids = rt_engine.processor.tokenizer.encode(str(req["text"]))
                    h.append_text(np.asarray(ids, np.int64))
                    body = {"session": sid, "appended_tokens": len(ids)}
                else:
                    h.end_text()
                    body = {"session": sid, "ended": True}
            except Exception as e:  # append after end or after the session ended
                self._json_error(409, str(e))
                return
            self._json(200, body)

        def _rt_response(self, text: str, seed: int, priority: bool, live: bool):
            """Chunked WAV from the streaming model, a chunk per frame."""
            sid = None
            if rt_engine is not None:
                handle = rt_engine.submit_text(text, priority=priority, live=live)
                frames = handle.frames(timeout=request_timeout)
                close = handle.cancel
                if live:
                    sid = uuid.uuid4().hex
                    live_rt[sid] = handle
            else:
                frames = rt.stream(text, seed=seed, ddpm_steps=rt_ddpm_steps)
                close = frames.close
            try:
                self._stream(frames, close, lambda: None, sid)
            finally:
                if sid is not None:
                    live_rt.pop(sid, None)  # appends from now on are 404
                close()  # cancel() for a session, close() for one stream

        def _write_chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        def _stream(self, frames, cancel, error, sid=None):
            """Chunked WAV: the unknown-length header at once, then PCM a
            frame; a dead client cancels the work."""
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            if sid is not None:
                self.send_header("X-Session-Id", sid)  # for /tts/rt/append and /end
            self.end_headers()
            try:
                self._write_chunk(STREAM_WAV_HEADER)
                self.wfile.flush()
                for frame in frames:
                    self._write_chunk(pcm16(frame))
                    self.wfile.flush()
                if error() is not None:
                    raise error()
            except (BrokenPipeError, ConnectionResetError):
                cancel()
                return
            except Exception:  # the stream has started: end it cleanly below
                if verbose:
                    import traceback

                    traceback.print_exc()
            if sid is not None:  # unregistered before the client can see the end
                live_rt.pop(sid, None)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    server.engine = engine
    server.rt_engine = rt_engine
    server.live_sessions = live_rt  # X-Session-Id -> the live session's handle
    return server


def main(argv=None):
    args = parse_args(argv)
    followers, mesh = [], None
    if args.tp > 1:
        import multiprocessing as mp

        from ..parallel.mesh import free_port

        port = free_port()
        ctx = mp.get_context("spawn")
        followers = [ctx.Process(target=_follow, args=(args, r, port), daemon=True)
                     for r in range(1, args.tp)]
        for proc in followers:
            proc.start()
        args.device, mesh = _join_tp(args, 0, port)
    try:
        server = build_server(args, mesh=mesh)
    except BaseException:
        for proc in followers:
            proc.kill()
        raise
    host, port = server.server_address[:2]
    print(f"Serving on http://{host}:{port} (POST /tts, /tts/stream, /tts/rt, /v1/audio/speech; "
          "GET /health, /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.engine.shutdown()
        if server.rt_engine is not None:
            server.rt_engine.shutdown(drain=False)
        for proc in followers:
            proc.join(60)
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
