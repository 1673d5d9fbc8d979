"""mamba2-370m in the port against the JAX package on the CPU (f32 SMOKE
config unless stated; the JAX weights bridged over).

mamba2-370m SMOKE: 2 layers, d 128, d_inner 256 in 8 SSM heads of 32,
state 32, conv 4, chunk 32, tied embeddings, no FFN (d_ff = 0) and no
attention.  The port runs the SSD mixer as plain PyTorch (``models.ssm``),
as the reference runs plain JAX.

Tolerance: 4e-5 of max|reference| throughout.  The largest distance seen
is ~2e-6 of max (the prefill's logits and states); the SSD scan against a
step-by-step float64 recurrence of the same inputs lies within 1e-5 of
max in both packages (``test_ssd_chunked_against_the_recurrence``).

* The config against the JAX one, the registry, the parameter tree, its
  count and ``bridge.params_from_numpy``'s checks.
* ``_causal_conv`` (from zeros and from a state), ``ssd_chunked``,
  ``ssm_forward``'s prefill and its S = 1 decode (outputs and states).
* The prefill step: logits, ``conv_state`` / ``ssd_state``, ``pos``.
* The loop: exact mode whatever the mode asked (no attention), 18 steps,
  every step's logits and the ids; ``--budget`` / ``--quant`` refused.
* The frozen state: the JAX loop never writes a step's SSM state back,
  so the SMOKE bf16 loop of ``python -m repro.launch.serve --arch
  mamba2-370m --smoke --prompt-len 64 --tokens 3 --impl xla`` prints one
  token four times; the port, on the same bridged weights and prompt,
  prints the same four, and its cache still holds the prefill's state.
* The engine refuses it with ``ValueError``, as the JAX engine does.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.launch import serve as j_launch
from repro.models import common as jcm
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serve import prefill as jpf
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import serve as launch
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.engine import EngineConfig, ServingEngine
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.serve.serve_step import make_serve_step

ARCH = "mamba2-370m"
B, S = 2, 64
REL = 4e-5
TOKENS = 18


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
  """(JAX cfg, JAX params, port cfg, port params, prompt) in f32."""
  jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32)


def _close(got, want, rel=REL):
  got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                   np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * float(np.abs(want).max()))


def _t(a):
  return torch.from_numpy(np.array(a))


def _layer0(jparams, params):
  """Layer 0's SSM weights: JAX's and the port's."""
  return (jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["ssm"]),
          tf.layer_params(params["blocks"]["pos0"], 0)["ssm"])


# -- config and parameters ----------------------------------------------------

def test_config_matches_jax():
  for smoke in (False, True):
    got, want = get_config(ARCH, smoke=smoke), j_get_config(ARCH,
                                                             smoke=smoke)
    for name in ("n_layers", "d_model", "d_ff", "vocab", "norm_eps",
                 "tie_embeddings"):
      assert getattr(got, name) == getattr(want, name), (smoke, name)
    assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    assert [(s.kind, s.use_moe) for s in got.block_pattern] == \
        [(s.kind, s.use_moe) for s in want.block_pattern] == \
        [("mamba", False)]
    assert kvc.n_attn_positions(got) == 0 and kvc.n_ssm_positions(got) == 1
  assert ARCH in list_archs()
  full = get_config(ARCH)
  assert full.dtype == torch.bfloat16 and full.n_blocks == 48
  # The port also counts the norm gains, the conv, A_log, D, dt_bias and
  # in_proj's dt columns: 0.3683B against JAX's 0.3661B.
  assert full.param_count() == 368_338_432
  assert j_get_config(ARCH).param_count() == 366_059_520


def test_parameter_tree_count_and_init(model):
  """The port's init draws the JAX tree's leaves at their shapes (no
  ``ln2`` / ``mlp``: d_ff = 0) with the JAX init's fixed leaves;
  ``param_count`` counts every leaf."""
  _, jparams, cfg, params, _ = model
  mine = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
  n = 0
  for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
    node = mine
    for p in path:
      node = node[p.key]
    assert tuple(node.shape) == leaf.shape, path
    n += leaf.size
  assert cfg.param_count() == n
  assert set(mine["blocks"]["pos0"]) == {"ln1", "ssm"}
  j_ssm, _ = _layer0(jparams, params)
  m_ssm = tf.layer_params(mine["blocks"]["pos0"], 0)["ssm"]
  for name in ("A_log", "D", "dt_bias", "norm", "conv_b"):
    _close(m_ssm[name], j_ssm[name], rel=1e-6)
  # conv_w's scale is 0.5 (truncated at 2 sigma), in_proj's d^-0.5.
  assert float(m_ssm["conv_w"].abs().max()) <= 1.0
  assert float(m_ssm["in_proj"].abs().max()) <= 2 * cfg.d_model ** -0.5


def test_bridge_checks_the_ssm_leaves(model):
  _, jparams, cfg, _, _ = model
  tree = jax.tree.map(np.asarray, jparams)
  del tree["blocks"]["pos0"]["ssm"]["dt_bias"]
  with pytest.raises(KeyError, match="ssm/dt_bias"):
    bridge.params_from_numpy(tree, cfg, "cpu")
  bf16 = get_config(ARCH, smoke=True)
  p = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), bf16,
                               "cpu")
  # A_log, D and dt_bias in the model's dtype, as the JAX loop casts them.
  assert {p["blocks"]["pos0"]["ssm"][k].dtype
          for k in ("A_log", "D", "dt_bias")} == {torch.bfloat16}


# -- the mixer ----------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state"])
def test_causal_conv_matches_jax(with_state):
  rng = np.random.default_rng(1)
  u = rng.standard_normal((2, 7, 24)).astype(np.float32)
  w = rng.standard_normal((4, 24)).astype(np.float32)
  b = rng.standard_normal(24).astype(np.float32)
  st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state \
      else None
  y_j, s_j = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                               jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
  y, s = ssm._causal_conv(_t(u), _t(w), _t(b), None if st is None else _t(st))
  _close(y, y_j)
  np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def _ssd_inputs(seed=2, b=2, s=64, h=4, p=8, n=16):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((b, s, h, p)).astype(np.float32)
  dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
  A = -np.linspace(1.0, 16.0, h).astype(np.float32)
  Bs = rng.standard_normal((b, s, n)).astype(np.float32)
  Cs = rng.standard_normal((b, s, n)).astype(np.float32)
  return x, dt, A, Bs, Cs


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_jax(chunk):
  args = _ssd_inputs()
  y_j, st_j = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
  y, st = ssm.ssd_chunked(*map(_t, args), chunk)
  _close(y, y_j)
  _close(st, st_j)


def _recurrence(x, dt, A, Bs, Cs):
  """The SSD as its step-by-step recurrence, in float64: h_t = exp(dt_t A)
  h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t."""
  x, dt, A, Bs, Cs = (np.asarray(a, np.float64) for a in (x, dt, A, Bs, Cs))
  b, s, h, p = x.shape
  st = np.zeros((b, h, p, Bs.shape[-1]))
  ys = []
  for t in range(s):
    st = st * np.exp(dt[:, t] * A)[:, :, None, None] + np.einsum(
        "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bs[:, t])
    ys.append(np.einsum("bhpn,bn->bhp", st, Cs[:, t]))
  return np.stack(ys, 1), st


def test_ssd_chunked_against_the_recurrence():
  """Both packages' f32 chunked scans (four chunks of 16) within 1e-5 of
  max of the float64 recurrence: the chunking changes nothing but
  rounding."""
  args = _ssd_inputs()
  want_y, want_st = _recurrence(*args)
  y_j, st_j = jssm.ssd_chunked(*map(jnp.asarray, args), 16)
  y, st = ssm.ssd_chunked(*map(_t, args), 16)
  for got_y, got_st in ((y, st), (y_j, st_j)):
    _close(got_y, want_y, rel=1e-5)
    _close(got_st, want_st, rel=1e-5)


def test_ssm_forward_prefill_and_decode_match_jax(model):
  """The prefill branch over 64 tokens, then three S = 1 decode steps
  each from the state the previous one left, in both packages."""
  jcfg, jparams, cfg, params, _ = model
  jp, p = _layer0(jparams, params)
  rng = np.random.default_rng(3)
  x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
  y_j, st_j = jssm.ssm_forward(jnp.asarray(x), jp, jcfg)
  y, st = ssm.ssm_forward(_t(x), p, cfg)
  _close(y, y_j)
  for a, b in zip(st, st_j):
    _close(a, b)
  assert st[0].dtype == torch.float32 and st[1].dtype == torch.float32
  for i in range(3):
    xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    y_j, st_j = jssm.ssm_forward(jnp.asarray(xt), jp, jcfg,
                                 decode_state=st_j)
    y, st = ssm.ssm_forward(_t(xt), p, cfg, decode_state=st)
    _close(y, y_j)
    for a, b in zip(st, st_j):
      _close(a, b)


# -- prefill and the loop -----------------------------------------------------

def test_prefill_matches_jax(model):
  jcfg, jparams, cfg, params, prompt = model
  lg_j, cache_j = jax.jit(jpf.make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  lg, cache = make_prefill_step(cfg)(params, torch.from_numpy(prompt).long())
  assert set(cache) == set(cache_j) == {"conv_state", "ssd_state", "pos"}
  _close(lg, lg_j)
  for name in ("conv_state", "ssd_state"):
    assert tuple(cache[name].shape) == cache_j[name].shape
    _close(cache[name], cache_j[name])
  np.testing.assert_array_equal(cache["pos"].numpy(),
                                np.asarray(cache_j["pos"]))
  want = kvc.cache_struct(cfg, B, S, synopsis=False)
  assert {k: v[0] for k, v in want.items()} == {
      k: tuple(v.shape) for k, v in cache.items()}


def _jax_exact_loop(jcfg, jparams, prompt, tokens):
  """The JAX loop in exact mode (what it runs for an arch with no
  attention): each step from the prefill's SSM state, only ``pos``
  advancing.  Every step's logits and the ids."""
  logits, cache = jax.jit(jpf.make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  step = jax.jit(j_make_serve_step(jcfg, mode="exact", i_max=0, impl="xla"))
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  ids, out = [tok], [np.asarray(logits)]
  for _ in range(tokens):
    logits, st = step(jparams, cache, tok)
    cache["pos"] = st["pos"]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ids.append(tok)
    out.append(np.asarray(logits))
  return np.asarray(jnp.concatenate(ids, 1)), out


@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_loop_matches_jax_every_step(model, mode):
  """Asked for synopsis or exact, the loop runs exact (no attention):
  no build, budget 0 each step, the ids and every step's logits of the
  JAX loop."""
  jcfg, jparams, cfg, params, prompt = model
  want_ids, want_logits = _jax_exact_loop(jcfg, jparams, prompt, TOKENS)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=TOKENS, device="cpu",
                   params=params, prompt=torch.from_numpy(prompt).long(),
                   mode=mode, keep_logits=True, log=lambda _: None)
  assert out["budgets"] == [0] * TOKENS and out["build_ms"] == 0.0
  assert out["absorbs"] == 0
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  for got, want in zip(out["step_logits"], want_logits):
    _close(got, want)


def test_loop_refuses_budgets_and_quant(model, capsys, monkeypatch):
  _, _, cfg, params, _ = model
  with pytest.raises(ValueError, match="budgets"):
    launch.run(cfg, batch=B, prompt_len=S, tokens=2, device="cpu",
               params=params, budgets=[1, 1], log=lambda _: None)
  with pytest.raises(ValueError, match="quant"):
    launch.run(launch.apply_quant(cfg, "int8"), batch=B, prompt_len=S,
               tokens=2, device="cpu", params=params, log=lambda _: None)
  for flags in (["--budget", "1"], ["--quant", "int8"]):
    with pytest.raises(SystemExit):
      launch.main(["--arch", ARCH, "--device", "cpu", "--prompt-len", "64",
                   "--tokens", "2", *flags])
    assert "--mode exact" in capsys.readouterr().err


def _jax_launcher_ids(monkeypatch, argv):
  """The ids ``python -m repro.launch.serve <argv>`` prints."""
  monkeypatch.setattr(sys, "argv", ["serve", *argv])
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    j_launch.main()
  line = [ln for ln in buf.getvalue().splitlines()
          if ln.startswith("generated:")][-1]
  return eval(line.split(":", 1)[1])              # a printed list of ints


def test_frozen_state_quirk_as_the_jax_loop(monkeypatch):
  """The JAX launcher's SMOKE bf16 loop on mamba2 repeats one token: no
  step writes its SSM state back.  The port's loop, on the launcher's
  weights (seed 0, cast to bf16) and prompt (``fold_in(key, 0)``) through
  the bridge, prints the same ids, and ends holding the prefill's state
  bit for bit, though a step moves it."""
  argv = ["--arch", ARCH, "--smoke", "--prompt-len", "64", "--tokens", "3",
          "--impl", "xla"]
  want = _jax_launcher_ids(monkeypatch, argv)
  assert want == [474, 474, 474, 474]
  jcfg, cfg = j_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
  key = jax.random.PRNGKey(0)
  jparams, _ = jcm.split(jtf.init_model(key, jcfg))
  jparams = jax.tree.map(lambda a: a.astype(jcfg.dtype), jparams)
  prompt = jax.random.randint(jax.random.fold_in(key, 0), (B, 64), 0,
                              jcfg.vocab)
  params = bridge.params_from_numpy(
      jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), cfg, "cpu")
  out = launch.run(cfg, batch=B, prompt_len=64, tokens=3, device="cpu",
                   params=params, prompt=torch.from_numpy(
                       np.array(prompt)).long(), log=lambda _: None)
  assert out["tokens"][0].tolist() == want
  # The loop's cache still holds the prefill's state, which a step moves.
  _, cache = make_prefill_step(cfg)(params, torch.from_numpy(
      np.array(prompt)).long())
  _, st = make_serve_step(cfg, mode="exact")(params, cache,
                                             out["tokens"][:, :1])
  for name in ("conv_state", "ssd_state"):
    assert torch.equal(out["cache"][name], cache[name])
    assert not torch.equal(st[name], cache[name])


# -- the engine ---------------------------------------------------------------

def test_engine_refuses_it_as_jax(model):
  jcfg, jparams, cfg, params, _ = model
  kw = dict(n_slots=2, prompt_len=S, max_new_tokens=2)
  with pytest.raises(ValueError, match="no attention positions"):
    JServingEngine(jcfg, JEngineConfig(impl="xla", **kw), params=jparams)
  with pytest.raises(ValueError, match="no attention positions"):
    ServingEngine(cfg, EngineConfig(**kw), params=params, device="cpu")
  with pytest.raises(ValueError, match="no attention positions"):
    launch.main(["--arch", ARCH, "--engine", "--device", "cpu",
                 "--prompt-len", "64", "--tokens", "2"])
