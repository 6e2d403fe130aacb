"""Tensor-parallel serving in the port (ServingEngine(mesh=), the server's
--tp) against the JAX package's engine on a tp mesh, on the CPU.

The port's engine runs SPMD, one process per rank: gloo worlds of 1 and 2
spawned by tests/torch_workers.py (which import nothing of JAX); the JAX
engine runs in this process on the virtual CPU mesh of tests/conftest.py
(tests/test_serving.py:683-715). Every frame is forced to
speech_diffusion and the initial latents come from one numpy bank indexed
by each slot's diffusion count, so a request's audio does not depend on
when it joins; three requests of 20, 30 and 10 frames share two slots, the
second and third submitted while the first decodes (they join between its
windows, and the third waits for its slot).

Tolerance: f32 audio within 1e-5 of its peak; tokens equal on every rank.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.parallel import mesh as jmesh
from vibevoice_tpu.serving import Request as JRequest
from vibevoice_tpu.serving import ServingEngine as JServingEngine

import torch_workers as W
from test_torch_parallel import randomize, rel
from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.utils.params import from_jax

CFG, JCFG = tiny_config(), jax_tiny_config()
TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
K, SLOTS, MAX_LEN = 2, 2, 96
FRAMES = (20, 30, 10)
REPO = Path(__file__).resolve().parents[1]


def _requests():
    out = []
    for i, frames in enumerate(FRAMES):
        n = 6 + i
        ids = np.random.RandomState(i).randint(10, 100, (1, n)).astype(np.int64)
        ids[0, -1] = TOK["speech_start"]
        out.append((ids, (frames + 0.5) / n))
    return out


def _jax_engine_audio(jp, init):
    """JAX's engine on a tp-2 mesh, every request submitted at once."""
    opts = jinf.GenerateOptions(ddpm_steps=2, max_length=MAX_LEN)
    jtok = jinf.SpecialTokens(**TOK)
    eng = JServingEngine(JCFG, jp, tokens=jtok, opts=opts, max_batch=SLOTS, max_len=MAX_LEN,
                         frames_per_dispatch=K, mesh=jmesh.make_mesh(dp=1, tp=2))
    real = jinf.make_multi_step_fn(JCFG, jtok, opts, K, inject=True)
    hooks = {"forced": jnp.full((K, SLOTS), TOK["speech_diffusion"], jnp.int32),
             "init": jnp.asarray(init)}
    eng.step_fn = lambda p, c, key, ext: real(p, c, key, ext, hooks)
    try:
        handles = [eng.submit(JRequest(input_ids=ids, valid_mask=np.ones_like(ids, bool),
                                       max_length_times=x)) for ids, x in _requests()]
        return [h.result(timeout=240) for h in handles]
    finally:
        eng.shutdown()


def test_tp_engine_matches_jax_and_tp1(tmp_path):
    """The port's engine at tp 2 and at tp 1 (a world of one) against JAX's
    engine at tp 2 and the port's engine without a mesh: each request's
    audio (FRAMES[i] frames of HOP samples); both ranks' windows chose the
    same tokens; two requests joined while the first was decoding and none
    hung (each world has a time limit). A world of one also refuses an
    int8 LM, as JAX's engine does."""
    jp = randomize(jvv.init(jax.random.PRNGKey(0), JCFG), 1)
    tp = from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    init = np.random.RandomState(9).randn(32, SLOTS, CFG.acoustic_vae_dim).astype(np.float32)
    args = (CFG, tp, _requests(), K, SLOTS, MAX_LEN, init, TOK, True)
    dense = W.tp_engine(None, *args)
    tp2 = W.run_world(2, tmp_path / "tp2", {"e": (("mesh", 1, 2), W.tp_engine, args)})
    tp1 = W.run_world(1, tmp_path / "tp1", {"e": (("mesh", 1, 1), W.tp_engine, args),
                                            "int8": (("mesh", 1, 1), W.engine_refuses_int8,
                                                     (CFG, tp))})
    want = _jax_engine_audio(jp, init)
    hop = CFG.acoustic_tokenizer_config.hop_length
    assert [len(a) for a in want] == [f * hop for f in FRAMES]
    for run in (dense, tp1[0]["e"], tp2[0]["e"]):
        assert run["joined_while_decoding"]
        for got, ref in zip(run["audio"], want):
            assert got.shape == ref.shape and rel(got, ref) <= 1e-5
    logs = [r["e"]["token_log"] for r in tp2]
    assert len(logs[0]) == len(logs[1]) > 0
    assert all(np.array_equal(a, b) for a, b in zip(*logs))
    assert "TP serving shards dense ('w') params" in tp1[0]["int8"]


def test_tp_engine_drains_a_joining_request(tmp_path):
    """shutdown(drain=True) on rank 0 of a tp-2 engine, begun while the
    request is being taken into its slot, lets it run to its end on both
    ranks (torch_workers.tp_engine_drain widens the moment between the
    queue's task_done and the next window)."""
    tp = from_jax(jax.tree.map(np.asarray, randomize(
        jvv.init(jax.random.PRNGKey(0), JCFG), 1)), CFG, device="cpu")
    ids, x = _requests()[0]
    frames = 6
    res = W.run_world(2, tmp_path / "drain", {"d": (("mesh", 1, 2), W.tp_engine_drain,
                                                    (CFG, tp, ids, frames, TOK, MAX_LEN))})
    hop = CFG.acoustic_tokenizer_config.hop_length
    assert res[0]["d"] == {"error": None, "samples": frames * hop}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_tp2_smoke_answers_tts():
    """`python -m vibevoice_tpu_torch.serving.server --tp 2 --smoke --device
    cpu` starts its second rank itself, answers /health and POST /tts with a
    WAV, and stops both ranks on SIGINT."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "vibevoice_tpu_torch.serving.server", "--smoke", "--device", "cpu",
         "--tp", "2", "--port", str(port), "--max_len", "256", "--ddpm_steps", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/health")
                health = json.loads(conn.getresponse().read())
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.3)
        assert health["status"] == "ok"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/tts", body=json.dumps({"text": "Speaker 1: hello there"}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200 and body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        assert len(body) >= 44 and (len(body) - 44) % 2 == 0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out[-2000:]
