"""The port's HTTP server (vibevoice_tpu_torch/serving/server.py) on the CPU,
in-process on port 0, over engines built here (tests/test_http_* of the JAX
package's demo/serve.py, on the port): /tts whole and chunked, the
OpenAI-shaped /v1/audio/speech and its errors, /tts/rt through the session
engine, a live session with /append and /end that parks for longer than
--request_timeout without being cancelled, /health and /stats; and the
command line's model options.

The multi-speaker engine runs test_torch_serving's speaking weights, so
requests return audio; the streaming engine runs StreamingTTS.smoke with the
EOS classifier's bias at +30, so a session speaks one frame a quantum and
then parks (live) or ends. Every wait has its own bound."""

import http.client
import json
import struct
import threading

import pytest
import torch

from vibevoice_tpu_torch.models import inference as inf
from vibevoice_tpu_torch.serving import ServingEngine
from vibevoice_tpu_torch.serving import server as srv
from vibevoice_tpu_torch.serving.streaming_sessions import StreamingSessionEngine
from vibevoice_tpu_torch.tts import StreamingTTS, VibeVoiceTTS

from test_torch_serving import speaking
from test_torch_streaming import _with_eos_bias

TIMEOUT = 120
REQUEST_TIMEOUT = 3.0  # s: a live session below parks for longer than this


@pytest.fixture(scope="module")
def server():
    tts = VibeVoiceTTS.smoke(device="cpu")
    engine = ServingEngine(tts.cfg, speaking(tts.params, alpha=10.0, beta=10.0),
                           tokens=tts.tokens, max_batch=2, max_len=96,
                           opts=inf.GenerateOptions(ddpm_steps=2, max_length=96),
                           frames_per_dispatch=2)
    rt = StreamingTTS.smoke(device="cpu")
    rt_engine = StreamingSessionEngine(rt.cfg, _with_eos_bias(rt.params, 30.0), n_slots=2,
                                       max_len=256, default_preset=rt.preset,
                                       processor=rt.processor,
                                       opts=inf.GenerateOptions(cfg_scale=1.5, ddpm_steps=2))
    httpd = _serve(engine, tts.processor, rt_engine, TIMEOUT)
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    engine.shutdown()
    rt_engine.shutdown(drain=False)


def _serve(engine, processor, rt_engine, request_timeout):
    """A server over the given engines, serving on a thread."""
    args = srv.parse_args(["--port", "0", "--voices_dir", "/nonexistent",
                           "--request_timeout", str(request_timeout)])
    httpd = srv.build_server(args, engine=engine, processor=processor, rt_engine=rt_engine)
    httpd.processor = processor
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post(httpd, path, payload, raw=False):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=TIMEOUT)
    conn.request("POST", path, payload if raw else json.dumps(payload).encode(),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r, body


def _get(httpd, path):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=TIMEOUT)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def _whole_wav(wav: bytes) -> int:
    """Checks a whole-file WAV's header; its sample count."""
    assert wav[:4] == b"RIFF" and wav[8:16] == b"WAVEfmt "
    channels, rate, _, _, bits = struct.unpack("<HIIHH", wav[22:36])
    assert (channels, rate, bits) == (1, srv.SAMPLE_RATE, 16) and wav[36:40] == b"data"
    n = struct.unpack("<I", wav[40:44])[0] // 2
    assert struct.unpack("<I", wav[4:8])[0] == 36 + 2 * n and len(wav) == 44 + 2 * n
    return n


def _stream_wav(r, wav: bytes, hop: int) -> int:
    """Checks a chunked live WAV (unknown-length header, whole frames); its
    frame count."""
    assert r.status == 200 and r.getheader("Transfer-Encoding") == "chunked"
    assert wav[:44] == srv.STREAM_WAV_HEADER
    assert (len(wav) - 44) % (2 * hop) == 0
    return (len(wav) - 44) // (2 * hop)


def test_tts_whole_and_streamed(server):
    """/tts returns a whole WAV of the request's frame cap (2 x 12 tokens
    of the script, "Speaker 1: hello world" and its framing); /tts/stream
    the same frames chunked."""
    body = {"text": "Speaker 1: hello world"}
    r, wav = _post(server, "/tts", body)
    assert r.status == 200 and r.getheader("Content-Type") == "audio/wav"
    n = _whole_wav(wav)
    hop = server.engine._hop
    assert n > 0 and n % hop == 0
    r, stream = _post(server, "/tts/stream", body)
    assert _stream_wav(r, stream, hop) * hop == n


def test_openai_speech_formats_and_errors(server):
    """/v1/audio/speech: bare input in wav and pcm (the same samples), and
    OpenAI-shaped 400s for an unknown format, a missing input, an unknown
    voice with no voices and a body that is not JSON."""
    r, wav = _post(server, "/v1/audio/speech", {"model": "vibevoice", "input": "hello world"})
    assert r.status == 200 and r.getheader("Content-Type") == "audio/wav"
    n = _whole_wav(wav)
    r, pcm = _post(server, "/v1/audio/speech", {"input": "hello world", "response_format": "pcm"})
    assert r.status == 200 and r.getheader("Content-Type") == "audio/pcm"
    assert len(pcm) == 2 * n and n > 0
    for payload, raw, word in (({"input": "x", "response_format": "opus"}, False, "opus"),
                               ({}, False, "input"), ({"input": "x", "voice": "alloy"}, False,
                                                      "voice"),
                               (b"{not json", True, "bad request")):
        r, body = _post(server, "/v1/audio/speech", payload, raw=raw)
        err = json.loads(body)["error"]
        assert r.status == 400 and err["type"] == "invalid_request_error"
        assert word in err["message"].lower(), err


def test_voice_mapper_reads_the_voices_directory(tmp_path):
    """Names map to files by their stem ('en-Carter_man.wav' is 'Carter'),
    by containment, then to the first voice; no voices at all raise."""
    for f in ("en-Carter_man.wav", "en-Alice_woman.wav", "notes.txt"):
        (tmp_path / f).write_bytes(b"")
    m = srv.VoiceMapper(str(tmp_path))
    assert sorted(m.voice_presets) == ["Alice", "Carter"]
    assert m.get_voice_path("Carter").endswith("en-Carter_man.wav")
    assert m.get_voice_path("Dr. alice").endswith("en-Alice_woman.wav")
    assert m.get_voice_path("Bob").endswith("en-Alice_woman.wav")
    with pytest.raises(ValueError, match="No voice"):
        srv.VoiceMapper(str(tmp_path / "none")).get_voice_path("Bob")


def test_rt_plain_session_and_stats(server):
    """/tts/rt without live: one session through the session engine, one
    frame before its EOS ends it; /health and /stats (with the session
    engine's section) answer."""
    r, wav = _post(server, "/tts/rt", {"text": "hello streaming world"})
    assert _stream_wav(r, wav, server.rt_engine.cfg.acoustic_tokenizer_config.hop_length) == 1
    status, body = _get(server, "/health")
    assert status == 200 and json.loads(body) == {"status": "ok", "active": 0}
    status, body = _get(server, "/stats")
    st = json.loads(body)
    assert status == 200 and st["failed"] == 0 and st["rt_sessions"]["completed"] >= 1
    assert _get(server, "/nope")[0] == 404


def test_live_session_outlasts_the_request_timeout(server):
    """A live /tts/rt session (on a server over the same engines with a
    --request_timeout of 3 s) parks on its first frame's EOS and waits for
    text one and a half times --request_timeout without being cancelled; /append
    resumes it (one more frame), /end ends it and the chunked response
    closes with both frames; later appends are 404, a bad body 400."""
    quick = _serve(server.engine, server.processor, server.rt_engine, REQUEST_TIMEOUT)
    try:
        _live_session(quick)
    finally:
        quick.shutdown()
        quick.server_close()


def _live_session(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=TIMEOUT)
    conn.request("POST", "/tts/rt", json.dumps({"text": "hello there", "live": True}).encode(),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    sid = r.getheader("X-Session-Id")
    assert r.status == 200 and sid
    box = {}
    reader = threading.Thread(target=lambda: box.update(wav=r.read()), daemon=True)
    reader.start()
    handle = server.live_sessions[sid]
    assert handle.parked.wait(TIMEOUT)
    assert not threading.Event().wait(1.5 * REQUEST_TIMEOUT)  # time passes, parked
    assert not handle.cancelled.is_set() and not handle.done.is_set()
    assert json.loads(_get(server, "/stats")[1])["rt_sessions"]["parked"] == 1
    r2, body = _post(server, "/tts/rt/append", {"session": sid, "text": "and some more words"})
    assert r2.status == 200 and json.loads(body)["appended_tokens"] == 4
    r2, body = _post(server, "/tts/rt/end", {"session": sid})
    assert r2.status == 200 and json.loads(body)["ended"] is True
    reader.join(TIMEOUT)
    assert not reader.is_alive()
    conn.close()
    hop = server.rt_engine.cfg.acoustic_tokenizer_config.hop_length
    assert _stream_wav(r, box["wav"], hop) == 2
    assert handle.rec["outcome"] == "completed"
    r2, _ = _post(server, "/tts/rt/append", {"session": sid, "text": "x"})
    assert r2.status == 404
    r2, _ = _post(server, "/tts/rt/end", {})
    assert r2.status == 400


def test_command_line_models(monkeypatch, tmp_path):
    """--smoke --device cpu builds both tiny models and, with
    --rt_sessions 2, the session engine; a checkpoint directory without a
    config raises FileNotFoundError; --config or --model_path without a
    card raises naming device="cpu" (no fallback); no multi-speaker model
    option exits (a streaming checkpoint alone too). Serving a checkpoint:
    tests/test_torch_cli.py."""
    args = srv.parse_args(["--smoke", "--device", "cpu", "--port", "0", "--rt_sessions", "2",
                           "--max_len", "64", "--streaming_max_len", "256"])
    httpd = srv.build_server(args)
    try:
        assert httpd.rt_engine.n_slots == 2 and httpd.engine.max_len == 64
        assert httpd.engine.carry.h_pos.device.type == "cpu"
    finally:
        httpd.server_close()
        httpd.engine.shutdown()
        httpd.rt_engine.shutdown(drain=False)
    for argv, match in ((["--streaming_model_path", "x", "--device", "cpu"], "--model_path"),
                        ([], "--config 1.5b")):
        with pytest.raises(SystemExit, match=match):
            srv.build_server(srv.parse_args(argv))
    with pytest.raises(FileNotFoundError):
        srv.build_server(srv.parse_args(["--model_path", str(tmp_path), "--device", "cpu"]))
    if not torch.cuda.is_available():
        for argv in (["--config", "1.5b"], ["--model_path", str(tmp_path)]):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                srv.build_server(srv.parse_args(argv))
    assert srv._config("1.5b").endswith("qwen2.5_1.5b_64k.json")
