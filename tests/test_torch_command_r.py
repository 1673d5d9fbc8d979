"""command-r-plus-104b in the port against the JAX package on the CPU (f32
SMOKE config; the JAX weights bridged over).

command-r SMOKE: 2 layers, d 128, 8/2 heads of 16 (G = 4), SwiGLU d_ff
256, vocab 512, tied embeddings, rope 75000; every layer a parallel block,
``x + attn(h) + mlp(h)`` with ``h = ln1(x)`` and no ``ln2``; C 16, i_max
2, recent 16.  At full width G = 96 / 8 = 12, the kernels' head bucket of
16 on the card.

Tolerance: 4e-5 of max|reference| throughout (the floor of an arch
without a softcap, ROADMAP.md §C).  The checks shared with arctic-480b
are in ``tests/torch_arch_parity.py``.

* The config against the JAX one, the registry, the tree (no ``ln2``),
  its count against JAX's (the port adds the norm gains) and the
  12-layer cut the card runs; the bridge refusing a missing ``mlp`` leaf
  and an extra ``ln2`` (the JAX tree of a sequential block).
* One parallel layer against JAX's ``_layer_forward``, and the FFN
  present in the prefill, the decode step (both modes) and the delta
  replay: with every layer's MLP ``w2`` zeroed both packages move their
  output, and still agree.
* Prefill logits and KV, one serve step at budgets 0, 1 and M and exact,
  every step of both loops (18 steps, one absorb).
* The slot pool's leaves; the engine's ids, budgets and every step's
  logits under ``accuracytrader`` and ``basic``.
* ``supports_delta`` True as in JAX, a delta replay against JAX's
  ``make_extend_step``, and a corpus hit giving the miss's ids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_arch_parity as tap
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtf
from repro.serve import prefill as jpf
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve.prefill import make_extend_step, make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

ARCH = "command-r-plus-104b"


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
  return tap.load(ARCH)


@pytest.fixture(scope="module")
def caches(model):
  return tap.synopsis_cache(model)


# -- config and parameters ----------------------------------------------------

def test_config_matches_jax():
  tap.check_config(ARCH)
  full = get_config(ARCH)
  assert full.parallel_block and full.tie_embeddings and full.moe is None
  assert full.n_heads // full.n_kv_heads == 12
  # The port also counts the norm gains (ln1 a layer, final_norm).
  assert full.param_count() == 103_809_822_720
  assert j_get_config(ARCH).param_count() == 103_809_024_000
  assert full.param_count() - j_get_config(ARCH).param_count() == \
      tap.norm_gains(full)
  # The card's cut: 12 of 64 layers, ~44 GB of bf16 weights.
  cut = dataclasses.replace(full, n_layers=12)
  assert cut.param_count() == 22_020_255_744


def test_parameter_tree_and_count(model):
  tap.check_tree(model, {"ln1", "attn", "mlp"})


def test_bridge_refuses_a_missing_and_an_extra_leaf(model):
  tap.check_bridge_refuses(model, "blocks/pos0/mlp/w2", "blocks/pos0/ln2")


# -- the parallel block -------------------------------------------------------

def test_parallel_layer_matches_jax(model):
  """One layer's ``_layer_forward`` (the prefill's) against JAX's: the
  output and the layer's k / v."""
  jcfg, jparams, cfg, params, _, _ = model
  x = np.random.default_rng(4).standard_normal(
      (tap.B, tap.S, cfg.d_model)).astype(np.float32)
  jlp = tap.layer_slice(jparams["blocks"]["pos0"], 1)
  want, _, kv = jtf._layer_forward(jnp.asarray(x), jlp, jcfg,
                                   jcfg.block_pattern[0],
                                   jnp.arange(tap.S), None, False,
                                   collect_kv=True, impl="xla")
  lp = tf.layer_params(params["blocks"]["pos0"], 1)
  got, out = tf._layer_forward(torch.from_numpy(x), lp, cfg,
                               cfg.block_pattern[0], torch.arange(tap.S))
  tap.close(got, want)
  tap.close(out["k"], kv["k"])
  tap.close(out["v"], kv["v"])
  with pytest.raises(ValueError, match="parallel block"):
    tf.mlp_block(torch.from_numpy(x), lp, cfg, cfg.block_pattern[0])


def _no_mlp(tree):
  """A copy of the (JAX numpy or port) tree with every layer's MLP output
  projection zeroed: the parallel blocks' FFN adds nothing."""
  blocks = dict(tree["blocks"])
  lp = dict(blocks["pos0"])
  lp["mlp"] = dict(lp["mlp"], w2=lp["mlp"]["w2"] * 0)
  blocks["pos0"] = lp
  return dict(tree, blocks=blocks)


@pytest.mark.parametrize("path", ["prefill", "synopsis", "exact", "delta"])
def test_ffn_present_on_every_path(model, caches, path):
  """The parallel FFN on the prefill, the decode step in both modes and
  the delta replay: zeroing the MLP moves the port's logits far beyond
  the tolerance (a branch that dropped the FFN would not move them), and
  with the MLP zeroed the port still gives JAX's logits."""
  jcfg, jparams, cfg, params, prompt, _ = model
  jtree = jax.tree.map(np.asarray, jparams)
  runs = {}
  for name, jp, p in (("with", jtree, params),
                      ("without", _no_mlp(jtree), _no_mlp(params))):
    if path == "prefill":
      want = tap.prefill_jax(jcfg, jp, prompt)[0]
      got = make_prefill_step(cfg)(p, torch.from_numpy(prompt).long())[0]
    elif path == "delta":
      P = 32
      toks = prompt[:1]
      _, jpre = jpf.make_prefill_step(jcfg, impl="xla")(
          jp, jnp.asarray(toks[:, :P]))
      want = jpf.make_extend_step(jcfg)(jp, jnp.asarray(toks[:, P:]),
                                        jpre["k"], jpre["v"],
                                        jnp.int32(P))[0]
      got = make_extend_step(cfg)(p, torch.from_numpy(toks[:, P:]).long(),
                                  torch.from_numpy(np.array(jpre["k"])),
                                  torch.from_numpy(np.array(jpre["v"])),
                                  P)[0]
    else:
      exact_cache, jc = caches
      jc = jc if path == "synopsis" else exact_cache
      tok = np.array([[5], [77]], np.int32)
      kw = dict(mode=path, i_max=1)
      want = jax.jit(j_make_serve_step(jcfg, impl="xla", **kw))(
          jp, jc, jnp.asarray(tok))[0]
      got = make_serve_step(cfg, **kw)(p, tap.torch_cache(jc),
                                       torch.from_numpy(tok).long())[0]
    tap.close(got, want)
    runs[name] = got
  moved = float((runs["with"] - runs["without"]).abs().max())
  assert moved > 100 * tap.REL * float(runs["with"].abs().max())


def test_bridged_tree_has_no_ln2(model):
  _, jparams, cfg, params, _, _ = model
  assert "ln2" not in jparams["blocks"]["pos0"]
  assert "ln2" not in params["blocks"]["pos0"]
  p = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                               get_config(ARCH, smoke=True), "cpu")
  assert p["unembed"].dtype == torch.float32           # tied: embed.T
  assert p["blocks"]["pos0"]["mlp"]["w2"].dtype == torch.bfloat16


# -- prefill, steps and the loop ----------------------------------------------

def test_prefill_matches_jax(model):
  tap.check_prefill(model)


@pytest.mark.parametrize("mode,budget", [("synopsis", 0), ("synopsis", 1),
                                         ("synopsis", tap.S // 16),
                                         ("exact", 0)])
def test_serve_step_matches_jax(model, caches, mode, budget):
  tap.check_step(model, caches, mode, budget)


@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_loop_matches_jax_every_step(model, mode):
  tap.check_loop(model, mode)


# -- the engine and the corpus cache ------------------------------------------

@pytest.mark.parametrize("synopsis", [True, False])
def test_slot_pool_leaves_match_jax(model, synopsis):
  tap.check_pool(model, synopsis)


@pytest.mark.parametrize("policy", ["accuracytrader", "basic"])
def test_engine_matches_jax(model, policy):
  tap.check_engine(model, policy)


def test_delta_replay_matches_jax(model):
  tap.check_delta_replay(model)


def test_corpus_hit_gives_the_miss_ids(model):
  tap.check_corpus_hit(model)
