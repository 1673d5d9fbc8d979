"""One training step's loss and gradients in the port
(``repro_torch.train.train_step.loss_and_grads``, ``transformer``'s
training forward and loss) against ``jax.value_and_grad`` of the JAX
package's ``forward_loss``, and the port's microbatching against its own
full batch.

Bounds: the loss and every gradient, in an f32 config, within 4e-5 of
max|ref| per leaf.  smollm's and llama3's SMOKE gradients take 5e-4 of
max|ref| and mamba2's 1e-4 instead, with a float64 witness in the same
test (``WITNESSED_TOL``): smollm's and llama3's losses are 6-26 (logits
of order 100, no softcap), and each package's f32 gradient lies up to
4.1e-4 (smollm), 9.4e-5 (llama3) and 4.2e-5 (mamba2's A_log) of max from
the port's float64 gradient, so 4e-5 is below the f32 floor there.  The
reference's own microbatching test is red on this JAX version, so the
port's ``microbatches=4`` is held against its own ``microbatches=1``: the
gradients within 1e-6 of max|ref| in f32 (four slices' gradients summed
in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtf
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.common import leaves
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, loss_and_grads

GRAD_TOL = 4e-5
# The f32 floor of these SMOKE configs' gradients, witnessed in float64 by
# test_loss_and_grads_equal_jax.
WITNESSED_TOL = {"smollm-135m": 5e-4, "llama3-8b": 5e-4, "mamba2-370m": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _tree(tree):
  """A JAX / numpy tree -> tensors (dtypes kept)."""
  if isinstance(tree, dict):
    return {k: _tree(v) for k, v in tree.items()}
  return torch.from_numpy(np.array(tree))


def _batch(tokens, labels):
  return {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}


def _f32(arch):
  return (dataclasses.replace(j_get_config(arch, smoke=True),
                              dtype=jnp.float32),
          dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32))


def _close_rel(got, want, tol, what=""):
  want = np.asarray(want, np.float32)
  scale = max(float(np.abs(want).max()), 1e-30)
  np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                             atol=tol * scale, err_msg=what)


ARCHS = ["smollm-135m", "llama3-8b", "gemma2-2b", "deepseek-v2-236b",
         "mamba2-370m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(arch):
  """One f32 step's loss, its parts and every parameter's gradient,
  against ``jax.value_and_grad`` of the reference's ``forward_loss``:
  dense GQA (smollm, llama3), gemma2's local window and softcaps,
  deepseek's MLA and MoE (its aux loss in the loss) and mamba2's SSD.
  Where the bound is above 4e-5 (``WITNESSED_TOL``), the port's float64
  gradient is the witness: both packages' f32 gradients lie within the
  bound of it, and JAX's further than 4e-5."""
  jcfg, cfg = _f32(arch)
  jstate, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptConfig())
  tokens, labels = jdata.TokenStream(
      jdata.DataConfig(cfg.vocab, 64, 2, seed=1)).batch_at(0)
  (jl, jm), jg = jax.jit(jax.value_and_grad(
      lambda p: jtf.forward_loss(p, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(labels)), has_aux=True))(
                                     jstate["params"])
  loss, metrics, grads = loss_and_grads(cfg, _tree(jstate["params"]),
                                        _batch(tokens, labels))
  np.testing.assert_allclose(float(loss), float(jl), rtol=GRAD_TOL)
  for k in ("ce", "aux"):
    np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                               rtol=GRAD_TOL, atol=1e-7)
  want = dict(leaves(jax.tree.map(np.asarray, jg)))
  got = dict(leaves(grads))
  assert set(got) == set(want)
  tol = WITNESSED_TOL.get(arch, GRAD_TOL)
  for path, g in got.items():
    assert g.dtype == torch.float32
    _close_rel(g.numpy(), want[path], tol, path)
  if arch in WITNESSED_TOL:
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    _, _, g64 = loss_and_grads(
        cfg64, jax.tree.map(lambda a: torch.from_numpy(np.array(
            a, np.float64)), jstate["params"]), _batch(tokens, labels))
    floor = {"port": 0.0, "jax": 0.0}
    for path, x in leaves(g64):
      x = x.numpy()
      for side, y in (("port", got[path].numpy()), ("jax", want[path])):
        _close_rel(y, x, tol, f"{side} {path}")
        floor[side] = max(floor[side], np.abs(y - x).max() / np.abs(x).max())
    assert max(floor.values()) > GRAD_TOL, floor


def test_every_parameter_gets_a_gradient():
  """smollm's and llama3's f32 SMOKE steps: every gradient finite and not
  all zero (the training forward must not reach the prefill kernel, whose
  output carries no gradient)."""
  for arch in ("smollm-135m", "llama3-8b"):
    cfg = get_config(arch, smoke=True)
    state = init_train_state(cfg, OptConfig(),
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens, labels = TokenStream(DataConfig(cfg.vocab, 64, 2)).batch_at(0)
    _, _, grads = loss_and_grads(cfg, state["params"],
                                 _batch(tokens, labels))
    for path, g in leaves(grads):
      assert bool(torch.isfinite(g).all()), path
      assert float(g.abs().max()) > 0, path


def test_microbatching_matches_its_full_batch():
  """``microbatches=4`` against ``microbatches=1`` on the same batch, in
  f32: the loss and every gradient within 1e-6 of max|ref|."""
  _, cfg = _f32("llama3-8b")
  state = init_train_state(cfg, OptConfig(),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
  tokens, labels = TokenStream(DataConfig(cfg.vocab, 32, 8, seed=1)
                               ).batch_at(0)
  l1, _, g1 = loss_and_grads(cfg, state["params"], _batch(tokens, labels))
  l4, _, g4 = loss_and_grads(cfg, state["params"], _batch(tokens, labels),
                             microbatches=4)
  np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
  for (path, a), (_, b) in zip(leaves(g4), leaves(g1)):
    _close_rel(a.numpy(), b.numpy(), 1e-6, path)
  with pytest.raises(ValueError, match="microbatches"):
    loss_and_grads(cfg, state["params"], _batch(tokens, labels),
                   microbatches=3)


def test_causal_skip_and_chunks_equal_jax():
  """The training attention with several query chunks, with and without
  ``causal_skip``, on gemma2's sliding window: the loss against JAX's."""
  jcfg, cfg = _f32("gemma2-2b")
  jstate, _ = j_init_train_state(jax.random.PRNGKey(1), jcfg,
                                 jopt.OptConfig())
  tokens, labels = jdata.TokenStream(
      jdata.DataConfig(cfg.vocab, 1024, 1, seed=2)).batch_at(0)
  params = _tree(jstate["params"])
  with torch.no_grad():
    for skip in (False, True):
      want, _ = jtf.forward_loss(jstate["params"], jcfg,
                                 jnp.asarray(tokens), jnp.asarray(labels),
                                 causal_skip=skip)
      got, _ = tf.forward_loss(params, cfg, torch.from_numpy(tokens),
                               torch.from_numpy(labels), causal_skip=skip)
      np.testing.assert_allclose(float(got), float(want), rtol=GRAD_TOL)
