"""The port's training path (``repro_torch.train``) against the JAX
package: the token stream, the schedule, clipping, AdamW, the
error-feedback quantisation, checkpoints (a JAX-written one restored by
the port and the other way round), loss decrease and restart.  One step's
loss and gradients are held in ``tests/test_torch_train_grads.py``.

Bounds: one ``adamw_update`` on the same gradients within 1e-6.  The
updated weights of a whole step are not held across packages: Adam's
first step moves each weight by about lr * sign(g), so a 1e-7 difference
in a tiny gradient flips a whole update.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.train import checkpoint as jck
from repro.train import compression as jcomp
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch.configs.registry import get_config
from repro_torch.models.common import leaves
from repro_torch.train import checkpoint as ck
from repro_torch.train import compression as comp
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import (OptConfig, adamw_update, global_norm,
                                         init_opt_state, schedule)
from repro_torch.train.train_step import init_train_state, make_train_step

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
  return {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}


def _f32(arch):
  return (dataclasses.replace(j_get_config(arch, smoke=True),
                              dtype=jnp.float32),
          dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32))


# -- data, schedule, optimizer -------------------------------------------------

@pytest.mark.parametrize("corpus", [False, True])
def test_token_stream_equals_jax(corpus, tmp_path):
  path = None
  if corpus:
    path = str(tmp_path / "corpus.txt")
    with open(path, "wb") as f:
      f.write(bytes(range(256)) * 40)
  a = TokenStream(DataConfig(1000, 32, 4, seed=7, corpus_path=path))
  b = jdata.TokenStream(jdata.DataConfig(1000, 32, 4, seed=7,
                                         corpus_path=path))
  for step in (0, 5, 123):
    for x, y in zip(a.batch_at(step), b.batch_at(step)):
      np.testing.assert_array_equal(x, y)
  xa, ya = a.batch_at(5)
  np.testing.assert_array_equal(xa[:, 1:], ya[:, :-1])
  c = TokenStream(a.cfg)
  a.step = 9
  c.load_state_dict(a.state_dict())
  assert c.step == 9 and next(iter(c))[0].tolist() == a.batch_at(9)[0].tolist()


def test_schedule_equals_jax():
  cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
  jcfg = jopt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
  for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
    got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jopt.schedule(jcfg, jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
  assert float(schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
  assert float(schedule(cfg, torch.tensor(100, dtype=torch.int32))) < 2e-4


def _grads_like(params, seed, scale=1.0):
  rng = np.random.default_rng(seed)
  return {k: (_grads_like(v, seed + 1, scale) if isinstance(v, dict) else
              (scale * rng.standard_normal(np.shape(v))).astype(np.float32))
          for k, v in params.items()}


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_adamw_update_equals_jax(scale):
  """Three updates on the same gradients, unclipped (1e-3) and clipped
  (10): params, moments, step, grad norm and lr within 1e-6."""
  rng = np.random.default_rng(0)
  params = {"a": {"w": rng.standard_normal((4, 8)).astype(np.float32)},
            "b": rng.standard_normal((8,)).astype(np.float32)}
  jcfg = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
  cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
  jp, jo = jax.tree.map(jnp.asarray, params), None
  jo = jopt.init_opt_state(jp)
  tp = _tree(params)
  to = init_opt_state(tp)
  for i in range(3):
    g = _grads_like(params, i, scale)
    jp, jo, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jo, jp,
                                   jcfg)
    tp, to, tm = adamw_update(_tree(g), to, tp, cfg)
    for name, got, want in ((("params", tp, jp), ("m", to["m"], jo["m"]),
                             ("v", to["v"], jo["v"]))):
      for (path, x), (_, y) in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name}/{path}")
    assert int(to["step"]) == int(jo["step"]) == i + 1
    for k in ("grad_norm", "lr"):
      np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


def test_adamw_moves_toward_minimum_and_clips():
  cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                  total_steps=2000)
  params = {"w": torch.tensor([5.0])}
  opt = init_opt_state(params)
  for _ in range(150):
    params, opt, _ = adamw_update({"w": 2 * params["w"]}, opt, params, cfg)
  assert abs(float(params["w"][0])) < 0.3
  _, _, m = adamw_update({"w": torch.full((4,), 100.0)},
                         init_opt_state({"w": torch.zeros(4)}),
                         {"w": torch.zeros(4)}, OptConfig(warmup_steps=0))
  assert float(m["grad_norm"]) > 100
  assert float(global_norm({"a": torch.full((4,), 3.0),
                            "b": {"c": torch.full((16,), 2.0)}})) == 10.0


def test_compression_equals_jax_and_is_unbiased():
  g = np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32)
  q, s = comp._quantise(torch.from_numpy(g))
  jq, js = jcomp._quantise(jnp.asarray(g))
  np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
  assert q.dtype == torch.int8
  np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
  grads = {"a": torch.from_numpy(g)}
  err = comp.init_error_feedback(grads)
  total = torch.zeros(64)
  jerr = jcomp.init_error_feedback({"a": jnp.asarray(g)})
  for _ in range(50):
    deq, err = comp.local_quantise_feedback(grads, err)
    jdeq, jerr = jcomp.local_quantise_feedback({"a": jnp.asarray(g)}, jerr)
    np.testing.assert_allclose(deq["a"].numpy(), np.asarray(jdeq["a"]),
                               rtol=1e-6, atol=1e-6)
    total = total + deq["a"]
  np.testing.assert_allclose((total + err["a"]).numpy(), g * 50, rtol=1e-3,
                             atol=1e-3)
  # Outside a mesh with a pod axis the collective has no axis to reduce
  # over: the reference's NameError (tests/test_torch_mesh_tiers.py runs
  # it on a spawned (pod, data) world).
  with pytest.raises(NameError, match="unbound axis name: pod"):
    comp.compressed_pod_psum(grads, err)


def test_loss_decreases_tiny_model():
  """The reference test, on the port: 24 steps on two fixed batches."""
  cfg = get_config("smollm-135m", smoke=True)
  opt_cfg = OptConfig(lr=3e-3, warmup_steps=2, total_steps=30)
  state = init_train_state(cfg, opt_cfg,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
  data = TokenStream(DataConfig(cfg.vocab, 64, 8, seed=3))
  step = make_train_step(cfg, opt_cfg)
  losses = []
  for i in range(12):
    b = _batch(*data.batch_at(i % 2))
    state, _ = step(state, b)
    state, metrics = step(state, b)
    losses.append(float(metrics["loss"]))
  assert losses[-1] < losses[0] - 0.3, losses
  assert int(state["opt"]["step"]) == 24
  with pytest.raises(TypeError, match="Mesh"):
    make_train_step(cfg, opt_cfg, mesh=object())


# -- checkpoints -------------------------------------------------------------------

def test_checkpoint_roundtrip_atomic_and_latest(tmp_path):
  tree = {"a": {"b": torch.arange(6.0).reshape(2, 3)},
          "step": torch.tensor(7, dtype=torch.int32)}
  ck.save(str(tmp_path), 7, tree, extras={"data": {"step": 7}})
  got, step, extras = ck.restore(str(tmp_path))
  assert step == 7 and extras["data"]["step"] == 7
  assert torch.equal(got["a"]["b"], tree["a"]["b"])
  assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
  ck.save(str(tmp_path), 1, tree)
  ck.save(str(tmp_path), 5, tree)
  os.makedirs(tmp_path / "step_00000009.tmp", exist_ok=True)
  assert ck.latest_step(str(tmp_path)) == 7
  ck.save(str(tmp_path), 7, {"w": torch.ones(2)})        # overwrite in place
  assert set(ck.restore(str(tmp_path), 7)[0]) == {"w"}
  assert ck.latest_step(str(tmp_path / "none")) is None
  with pytest.raises(FileNotFoundError):
    ck.restore(str(tmp_path / "none"))


def test_async_checkpointer(tmp_path):
  c = ck.AsyncCheckpointer()
  w = torch.ones((4,))
  c.save_async(str(tmp_path), 3, {"w": w})
  w += 1                                   # the snapshot was taken at once
  c.wait()
  got, step, _ = ck.restore(str(tmp_path))
  assert step == 3 and got["w"].tolist() == [1.0] * 4


def test_checkpoints_cross_between_packages(tmp_path):
  """A train state that JAX's ``save`` wrote is restored by the port with
  every leaf, dtype and value; one the port wrote is restored by JAX."""
  jcfg, cfg = _f32("smollm-135m")
  jstate, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                 jopt.OptConfig())
  jck.save(str(tmp_path / "jax"), 4, jstate, extras={"data": {"step": 4}})
  got, step, extras = ck.restore(str(tmp_path / "jax"))
  assert step == 4 and extras == {"data": {"step": 4}}
  want = dict(leaves(jax.tree.map(np.asarray, jstate)))
  assert set(dict(leaves(got))) == set(want)
  for path, x in leaves(got):
    np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)
    assert str(x.numpy().dtype) == str(want[path].dtype), path
  ck.save(str(tmp_path / "port"), 9, got)
  back, s, _ = jck.restore(str(tmp_path / "port"))
  assert s == 9
  for path, x in leaves(back):
    np.testing.assert_array_equal(np.asarray(x), want[path], err_msg=path)
  # the port's step runs on the restored JAX state
  step_fn = make_train_step(cfg, OptConfig(warmup_steps=0, total_steps=10))
  tokens, labels = TokenStream(DataConfig(cfg.vocab, 32, 2)).batch_at(0)
  new, m = step_fn(got, _batch(tokens, labels))
  assert int(new["opt"]["step"]) == int(got["opt"]["step"]) + 1
  assert np.isfinite(float(m["loss"]))


def test_train_restart_resumes_identically(tmp_path):
  """Kill and restore reproduces the uninterrupted run on the CPU: six
  steps straight against three, a checkpoint, a restore and three more
  (every loss and every weight bit for bit)."""
  cfg = get_config("smollm-135m", smoke=True)
  opt_cfg = OptConfig(warmup_steps=0, total_steps=20)
  data = TokenStream(DataConfig(cfg.vocab, 32, 4, seed=5))
  step = make_train_step(cfg, opt_cfg)

  def run(state, a, b):
    losses = []
    for i in range(a, b):
      state, m = step(state, _batch(*data.batch_at(i)))
      losses.append(float(m["loss"]))
    return state, losses

  init = lambda: init_train_state(cfg, opt_cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
  ref_state, ref_losses = run(init(), 0, 6)
  state1, first = run(init(), 0, 3)
  ck.save(str(tmp_path), 3, state1)
  restored, s, _ = ck.restore(str(tmp_path))
  assert s == 3
  got_state, rest = run(restored, 3, 6)
  assert first + rest == ref_losses
  for (path, a), (_, b) in zip(leaves(got_state), leaves(ref_state)):
    assert torch.equal(a, b), path
