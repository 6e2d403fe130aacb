"""The port's entry points on checkpoints, on the CPU (--device cpu): the two
file CLIs (vibevoice_tpu_torch/demo/), the HTTP server's --model_path and
--streaming_model_path, the trainer's --model_path and
scripts/convert_checkpoint.py. The checkpoints are tiny and written here by
chip_smoke's reference-layout writer (tests/test_torch_hf_interop.py holds
it against the JAX package's converter): a multi-speaker model whose greedy
choice diffuses every frame (tests/test_torch_serving.py's speaking
weights, on an untied config so that the checkpoint carries the head), and
a streaming model with its EOS held off (bias -30) and a .npz preset. No
checkpoint carries tokenizer files, so VIBEVOICE_ALLOW_FALLBACK_TOKENIZER
is set, as it is on the card."""

import dataclasses
import http.client
import json
import struct
import threading

import numpy as np
import pytest
import torch

from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.demo import inference_from_file as cli
from vibevoice_tpu_torch.demo import streaming_inference_from_file as rt_cli
from vibevoice_tpu_torch.models import streaming as tst
from vibevoice_tpu_torch.scripts import convert_checkpoint
from vibevoice_tpu_torch.serving import server as srv
from vibevoice_tpu_torch.utils import hf_interop as thf
from vibevoice_tpu_torch.utils.params import init, init_streaming

import chip_smoke
from test_torch_hf_interop import _config_json, _streaming, _untied, assert_same_tree
from test_torch_serving import speaking

TIMEOUT = 120
RTF_LINE = "RTF:"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(multi-speaker dir, streaming dir, .npz preset, streaming cfg)."""
    root = tmp_path_factory.mktemp("ckpts")
    cfg = _untied(TC)
    params = speaking(init(cfg, seed=2, device="cpu"), alpha=10.0, beta=10.0)
    full = root / "full"
    sd = {k: v.contiguous() for k, v in chip_smoke.reference_state_dict(params).items()}
    chip_smoke.write_checkpoint(full, sd, _config_json(cfg))
    scfg = _streaming(TC)  # the fallback tokenizer's ids run to 1,023
    scfg = dataclasses.replace(scfg, decoder_config=dataclasses.replace(
        scfg.decoder_config, vocab_size=1024))
    sparams = init_streaming(scfg, seed=3, device="cpu")
    sparams["tts_eos_classifier"]["fc2"]["b"].fill_(-30.0)
    rt = root / "rt"
    sd = chip_smoke.reference_state_dict(sparams, streaming=True, lower_norm=False)
    chip_smoke.write_checkpoint(rt, {k: v.contiguous() for k, v in sd.items()}, _config_json(scfg))
    prompt = np.random.RandomState(0).randint(10, 200, (1, 12))
    preset = tst.build_voice_preset(scfg, sparams, prompt, neg_prompt_id=3, max_len=256)
    preset.save(str(root / "voice.npz"))
    return full, rt, root / "voice.npz", scfg


@pytest.fixture(autouse=True)
def fallback_tokenizer(monkeypatch):
    monkeypatch.setenv("VIBEVOICE_ALLOW_FALLBACK_TOKENIZER", "1")


def _wav_samples(path) -> int:
    body = path.read_bytes()
    assert body[:4] == b"RIFF" and body[8:16] == b"WAVEfmt "
    return struct.unpack("<I", body[40:44])[0] // 2


@pytest.mark.parametrize("int8", [False, True])
def test_inference_cli_on_a_checkpoint(checkpoints, tmp_path, capsys, int8):
    """inference_from_file --model_path ... --device cpu (dense, and --int8
    with the serving packs) writes its WAV, one frame of audio for each
    diffused frame, and prints the RTF line."""
    full = checkpoints[0]
    argv = ["--model_path", str(full), "--device", "cpu", "--output_dir", str(tmp_path),
            "--max_length", "48", "--ddpm_steps", "2", "--frames_per_dispatch", "2",
            "--device_dtype", "float32"] + (["--int8"] if int8 else [])
    res = cli.main(argv)
    out = capsys.readouterr().out
    assert RTF_LINE in out and "Generated tokens:" in out
    n = _wav_samples(tmp_path / "generated_0.wav")
    assert n > 0 and n % 8 == 0 and n / 24_000 == pytest.approx(res["audio_seconds"])
    assert res["generated_tokens"] >= n // 8 and set(res["load_walls"]) >= {"read", "convert"}


def test_streaming_cli_on_a_checkpoint(checkpoints, tmp_path, capsys):
    """streaming_inference_from_file --model_path ... --voice_preset .npz
    --device cpu writes its WAV (EOS held off: the cache's capacity stops
    it) and prints the time to first audio and the RTF line; without a
    preset it prefills a synthetic prompt; --int8 packs the vocoder."""
    _, rt, voice, _ = checkpoints
    for extra in (["--voice_preset", str(voice)], ["--int8"]):
        path = tmp_path / f"rt{len(extra)}.wav"
        res = rt_cli.main(["--model_path", str(rt), "--device", "cpu", "--max_len", "56",
                           "--ddpm_steps", "2", "--output_path", str(path),
                           "--text", "a short streaming test of the checkpoint"] + extra)
        out = capsys.readouterr().out
        assert RTF_LINE in out and "Time-to-first-audio:" in out
        n = _wav_samples(path)
        assert n > 0 and n % 8 == 0 and n / 24_000 == pytest.approx(res["audio_seconds"])


def test_clis_want_a_card_unless_told_cpu(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for main, argv in ((cli.main, []), (rt_cli.main, []),
                       (convert_checkpoint.main, ["--input", "x", "--output", "y"])):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)


def test_server_on_checkpoints(checkpoints):
    """serving/server.py --model_path ... --int8 --streaming_model_path ...
    --streaming_voice ... --device cpu: /health answers, one /tts request
    returns a whole WAV of whole frames, /tts/rt streams the streaming
    checkpoint's frames."""
    full, rt, voice, _ = checkpoints
    args = srv.parse_args(["--model_path", str(full), "--int8", "--device", "cpu",
                           "--streaming_model_path", str(rt), "--streaming_voice", str(voice),
                           "--port", "0", "--max_len", "64", "--ddpm_steps", "2",
                           "--frames_per_dispatch", "2", "--streaming_max_len", "56",
                           "--streaming_ddpm_steps", "2", "--voices_dir", "/nonexistent",
                           "--request_timeout", str(TIMEOUT)])
    httpd = srv.build_server(args)
    assert "lm_head_q" in httpd.engine.params
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]

    def call(method, path, payload=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        conn.request(method, path, None if payload is None else json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        body = r.read()
        conn.close()
        return r, body

    try:
        r, body = call("GET", "/health")
        assert r.status == 200 and json.loads(body)["status"] == "ok"
        r, body = call("POST", "/tts", {"text": "Speaker 1: hello from a checkpoint"})
        assert r.status == 200 and body[:4] == b"RIFF"
        n = struct.unpack("<I", body[40:44])[0] // 2
        assert n > 0 and n % 8 == 0 and len(body) == 44 + 2 * n
        r, body = call("POST", "/tts/rt", {"text": "and the streaming one"})
        assert r.status == 200 and body[:44] == srv.STREAM_WAV_HEADER
        assert len(body) > 44 and (len(body) - 44) % 16 == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.shutdown()


def test_trainer_on_a_checkpoint(checkpoints, tmp_path):
    """python -m vibevoice_tpu_torch.finetune.train --model_path ... --device
    cpu: the checkpoint loads at float32 (its own scale factors, not the
    random model's NaN) and two LoRA steps run to finite losses."""
    from vibevoice_tpu_torch.finetune import train

    res = train.main(["--model_path", str(checkpoints[0]), "--device", "cpu", "--max_steps", "2",
                      "--synthetic_data", "--use_lora", "--output_dir", str(tmp_path),
                      "--no_save", "--log_steps", "1"])
    assert len(res["steps"]) == 2
    assert all(np.isfinite(v) for step in res["steps"] for v in step.values()
               if isinstance(v, float))


@pytest.mark.parametrize("streaming", [False, True])
def test_convert_checkpoint_nnscaler(checkpoints, tmp_path, streaming):
    """scripts/convert_checkpoint.py --nnscaler --device cpu on an nnscaler
    checkpoint (model.model. keys, optimizer entries) gives a native
    directory that load_pretrained reads as the original checkpoint."""
    from safetensors.torch import load_file, save_file

    full, rt, _, _ = checkpoints
    src = rt if streaming else full
    sd = {}
    for f in sorted(src.glob("*.safetensors")):
        sd.update(load_file(str(f)))
    nn_dir = tmp_path / "nnscaler"
    nn_dir.mkdir()
    renamed = {("model." + k if k.startswith("model.") else k): v for k, v in sd.items()}
    renamed["optimizer.state.0"] = torch.zeros(2)
    save_file(renamed, str(nn_dir / "model.safetensors"))
    (nn_dir / "config.json").write_text((src / "config.json").read_text())
    out = tmp_path / "native"
    convert_checkpoint.main(["--input", str(nn_dir), "--output", str(out), "--nnscaler",
                             "--device", "cpu"] + (["--streaming"] if streaming else []))
    assert (out / "params.pkl").exists() and (out / "preprocessor_config.json").exists()
    got = thf.load_pretrained(str(out), dtype="float32", device="cpu")
    want = thf.load_pretrained(str(src), dtype="float32", device="cpu")
    assert got.model_type == want.model_type
    assert_same_tree(got.params, want.params)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
