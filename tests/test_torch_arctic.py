"""arctic-480b in the port against the JAX package on the CPU (f32 SMOKE
config; the JAX weights bridged over).

arctic SMOKE: 2 layers, d 128, 4/2 heads of 32 (G = 2), untied, vocab
512; every layer an MoE of 4 experts of 128 (top 2) with a dense SwiGLU
MLP of d_ff 128 beside it (``dense_parallel``); C 16, i_max 2, recent 16.
At full width each layer holds 128 experts of 4864 (capacity 1 at decode
up to T = 102 tokens) and G = 56 / 8 = 7.

Tolerance: 4e-5 of max|reference| throughout (the floor of an arch
without a softcap, ROADMAP.md §C).  The checks shared with command-r-plus
are in ``tests/torch_arch_parity.py``.

* The config against the JAX one, the registry, the tree (each layer
  ``moe`` and ``mlp``), its count against JAX's (the port adds the norm
  gains) and the 2-layer cut the card runs; the bridge refusing a missing
  ``mlp`` leaf and an extra ``ln2``.
* The FFN (``transformer.ffn``) against JAX's ``_ffn`` at prefill and
  decode: the MoE plus the dense MLP; zeroing the dense MLP moves the
  output by exactly its term.
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
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tf

ARCH = "arctic-480b"


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
  assert full.moe.dense_parallel and not full.parallel_block
  assert full.n_heads // full.n_kv_heads == 7
  # The port also counts the norm gains (ln1, ln2 a layer, final_norm).
  assert full.param_count() == 476_850_275_328
  assert j_get_config(ARCH).param_count() == 476_849_766_400
  assert full.param_count() - j_get_config(ARCH).param_count() == \
      tap.norm_gains(full)
  assert full.param_count(active=True) - j_get_config(ARCH).param_count(
      active=True) == tap.norm_gains(full)
  # The card's cut: 2 of 35 layers, ~55.4 GB of bf16 weights.
  cut = dataclasses.replace(full, n_layers=2)
  assert cut.param_count() == 27_681_131_520


def test_parameter_tree_and_count(model):
  tap.check_tree(model, {"ln1", "attn", "ln2", "moe", "mlp"})


def test_bridge_refuses_a_missing_and_an_extra_leaf(model):
  tap.check_bridge_refuses(model, "blocks/pos0/mlp/w3",
                           "blocks/pos0/ln1_post")


# -- the FFN ------------------------------------------------------------------

@pytest.mark.parametrize("rows", [(tap.B, tap.S), (tap.B, 1)],
                         ids=["prefill", "decode"])
def test_ffn_is_moe_plus_dense_mlp(model, rows):
  """``transformer.ffn`` on one layer against JAX's ``_ffn``: the MoE's
  routed experts plus the dense MLP beside them; without the dense MLP's
  term (its w2 zeroed) the output moves by exactly that term."""
  jcfg, jparams, cfg, params, _, _ = model
  spec = cfg.block_pattern[0]
  jlp = tap.layer_slice(jparams["blocks"]["pos0"])
  lp = tf.layer_params(params["blocks"]["pos0"], 0)
  x = np.random.default_rng(4).standard_normal(
      (*rows, cfg.d_model)).astype(np.float32)
  want, _ = jtf._ffn(jnp.asarray(x), jlp, jcfg, jcfg.block_pattern[0])
  got = tf.ffn(torch.from_numpy(x), lp, cfg, spec)
  tap.close(got, want)
  dense = tf.mlp(torch.from_numpy(x), lp["mlp"], cfg)
  assert float(dense.abs().max()) > 0.1 * float(got.abs().max())
  no_dense = dict(lp, mlp=dict(lp["mlp"], w2=torch.zeros_like(
      lp["mlp"]["w2"])))
  tap.close(got - tf.ffn(torch.from_numpy(x), no_dense, cfg, spec), dense)


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
