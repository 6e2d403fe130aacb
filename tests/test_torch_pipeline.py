"""The port's GPipe pipeline (parallel/pipeline.py) against the JAX
package on the CPU, in float32: the stacked layout's round trip, the
pipelined LM forward at pp 2 and 4 stages and 2 and 4 micro-batches
against JAX's pipelined_forward and bit for bit against the port's dense
forward, the gradients through both passes, and a full training step with
the LM routed through the pipe.

The port's stages are the ranks of gloo worlds of 2 and 4 spawned by
tests/torch_workers.py (which import nothing of JAX); JAX runs on the
8-device virtual CPU mesh of tests/conftest.py, as tests/test_pipeline.py
runs it. tiny_config with 4 layers (the pipe needs layers to split); a
right-padded batch of 4 exercises the masks.

Tolerance: f32 within 1e-5 of the peak; the dense forward bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.parallel import pipeline as jpl

import torch_workers as W
from test_torch_parallel import _batch, _draws, _same_run, _with_buffers, randomize, rel
from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.finetune import loss as tloss
from vibevoice_tpu_torch.parallel import pipeline as pl
from vibevoice_tpu_torch.utils.params import from_jax

CFG, JCFG = tiny_config(num_hidden_layers=4), jax_tiny_config(num_hidden_layers=4)
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    jp = dict(randomize(jvv.init(jax.random.PRNGKey(0), JCFG), 1))
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def _inputs(jp):
    dcfg = JCFG.decoder_config
    b, t = 4, 12
    ids = jax.random.randint(jax.random.PRNGKey(1), (b, t), 0, dcfg.vocab_size)
    valid = np.ones((b, t), bool)
    valid[1, 9:] = False
    valid[2, 7:] = False
    x = np.asarray(jq.embed_tokens(jp["lm"], ids), np.float32)
    w = (np.random.RandomState(4).randn(b, t, dcfg.hidden_size) * valid[..., None]).astype(
        np.float32)
    return x, valid, w


def test_stack_layers_roundtrip(params):
    """stack_layers gives JAX's (pp, L/pp, ...) leaves; unstack_layers gives
    the list layout back, bit for bit."""
    jp, tp = params
    for pp in (2, 4):
        stacked = pl.stack_layers(tp["lm"], pp)
        assert "layers" not in stacked
        jstacked = jpl.stack_layers(jp["lm"], pp)["layers_stacked"]
        got = dict(W._spec_leaves(stacked["layers_stacked"]))
        for p, x in W._spec_leaves(jax.tree.map(np.asarray, jstacked)):
            assert np.array_equal(got[p].numpy(), x), p
        back = pl.unstack_layers(stacked)
        flat = lambda tree: [v for _, v in W._spec_leaves(tree)]
        assert all(torch.equal(a, b) for a, b in zip(flat(back), flat(tp["lm"])))
        assert len(flat(back)) == len(flat(tp["lm"]))
    with pytest.raises(ValueError, match="4 layers not divisible by pp=3"):
        pl.stack_layers(tp["lm"], 3)


@pytest.mark.parametrize("pp", [2, 4])
def test_pipelined_forward_and_grads(tmp_path, params, pp):
    """pp stages over M = 2 and 4 micro-batches: the hidden states bit-equal
    to the port's dense forward and within 1e-5 of JAX's pipelined_forward
    on a pp mesh; the gradients of sum(h * w) w.r.t. the embeddings and
    each stage's layers within 1e-5 of the dense gradients' peak and of
    JAX's jax.grad through its pipe."""
    jp, tp = params
    x, valid, w = _inputs(jp)
    dense = W.pp_forward(None, CFG.decoder_config, tp["lm"], x, valid, w, 1)
    jobs = {m: (("pp", pp, 1), W.pp_forward, (CFG.decoder_config, tp["lm"], x, valid, w, m))
            for m in (2, 4)}
    ranks = W.run_world(pp, tmp_path, jobs)

    mesh = jpl.make_pp_mesh(pp=pp, dp=1)
    stacked = jpl.stack_layers(jp["lm"], pp)
    dev = jax.device_put(stacked, jpl.pp_lm_param_shardings(stacked, mesh))
    wm = jnp.asarray(w)

    for m in (2, 4):
        def pp_loss(layers, e):
            h = jpl.pipelined_forward(JCFG.decoder_config, {**stacked, "layers_stacked": layers},
                                      e, mesh, valid_mask=jnp.asarray(valid), n_microbatches=m)
            return jnp.sum(h * wm), h

        (_, jh), (jgl, jgx) = jax.jit(jax.value_and_grad(pp_loss, argnums=(0, 1), has_aux=True))(
            dev["layers_stacked"], jnp.asarray(x))
        jgl = {p: np.asarray(v) for p, v in W._spec_leaves(jax.tree.map(np.asarray, jgl))}
        dense_grads = {p: g.reshape((pp, -1) + g.shape[2:]) for p, g in dense["grads"].items()}
        for stage, r in enumerate(ranks):
            got = r[m]
            assert np.array_equal(got["h"], dense["h"]), (m, stage)
            assert rel(got["h"], jh) <= TOL
            assert rel(got["dx"], dense["dx"]) <= TOL and rel(got["dx"], jgx) <= TOL
            for p, g in got["grads"].items():
                key = eval(p)
                assert g.shape[0] == 1
                assert rel(g[0], dense_grads[p][stage]) <= TOL, (m, stage, p)
                assert rel(g[0], jgl[key][stage]) <= TOL, (m, stage, p)


def test_pp_train_step_matches_dense(tmp_path, params):
    """A training step with the LM routed through 2 stages (2 micro-batches,
    make_pp_lm_forward in train_forward's lm_forward hook): both steps'
    losses and the updated tree (in the list layout again) equal the port's
    one-device steps (tests/test_pipeline.py:138 holds JAX's pipe to its
    dense step the same way)."""
    jp, tp = params
    jp, tp = _with_buffers(jp, tp)
    batch = _batch(CFG)
    draws = _draws(CFG, jax.random.PRNGKey(1), batch)
    tb = tloss.Batch(*(np.asarray(x) for x in batch))
    dense = W.train_steps(None, CFG, tp, tb, draws, 2, 0)
    ranks = W.run_world(2, tmp_path, {"s": (("pp", 2, 1), W.train_steps,
                                            (CFG, tp, tb, draws, 2, 0, None, None,
                                             {"stages": 2, "microbatches": 2}))})
    _same_run(dense, ranks)
