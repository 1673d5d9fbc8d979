"""The port's serving loop against the JAX package, and the port's
boundaries.

* One synopsis decode step (``mode="synopsis"``, i_max=2): logits and KV
  deltas against ``make_serve_step(impl="xla")`` on the same synopsis
  cache, within 1e-4 (two f32 layers summed in another order).
* End to end: prefill -> build -> 18 decode steps (past recent=16, so one
  absorb runs) with a fixed budget schedule on both sides (the deadline
  controller reads wall time) generates the same token ids as the JAX
  loop at ``impl="xla"``, f32, SMOKE config, same weights and prompt.
* No module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
  package; without a CUDA device the launcher and ``chip_smoke.py``
  refuse to run unless the CPU is asked for.
"""
import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.models import common as jcm
from repro.models import transformer as jtf
from repro.serve import synopsis_kv as jskv
from repro.serve.prefill import make_prefill_step as j_make_prefill_step
from repro.serve.serve_step import make_serve_step as j_make_serve_step
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch
from repro_torch.serve.serve_step import make_serve_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 128
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# Budgets 0..2 (i_max=2) in a fixed order: every step kind on both sides.
BUDGETS = [2, 1, 0, 2, 2, 1, 0, 2, 1, 2, 0, 1, 2, 2, 1, 0, 2, 1]


@pytest.fixture(autouse=True, scope="module")
def _torch_f32():
  torch.backends.cuda.matmul.allow_tf32 = False
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def llama():
  jcfg = dataclasses.replace(j_get_config("llama3-8b", smoke=True),
                             dtype=jnp.float32)
  cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                            dtype=torch.float32)
  jparams, _ = jcm.split(jtf.init_model(jax.random.PRNGKey(0), jcfg))
  params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
  prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
  basis = np.array(jax.random.normal(
      jax.random.PRNGKey(0), (cfg.n_kv_heads * cfg.hd, 3), jnp.float32))
  return jcfg, jparams, cfg, params, prompt.astype(np.int32), basis


def _close(got, want, tol=STEP_TOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol)


def _jax_loop(jcfg, jparams, prompt, budgets):
  """The single-batch loop of ``repro.launch.serve`` with the budget of
  each step fixed."""
  logits, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  cache = jskv.build(cache, jcfg, impl="xla")
  steps = {}
  tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
  out = [tok]
  for b in budgets:
    if b not in steps:
      steps[b] = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=b,
                                           impl="xla"))
    logits, st = steps[b](jparams, cache, tok)
    cache = jskv.append_recent(cache, st["k_delta"], st["v_delta"])
    cache["pos"] = st["pos"]
    if int(cache["recent_len"][0]) >= jcfg.synopsis.recent:
      cache = jskv.absorb_recent(cache, jcfg, impl="xla")
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out.append(tok)
  return np.asarray(jnp.concatenate(out, 1)), np.asarray(logits), cache


def test_serve_step_matches_jax(llama):
  jcfg, jparams, cfg, params, prompt, _ = llama
  _, cache = jax.jit(j_make_prefill_step(jcfg, impl="xla"))(
      jparams, jnp.asarray(prompt))
  jc = jskv.build(cache, jcfg, impl="xla")
  tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
  tc["recent_len"] += 3                       # a partly filled ring
  jc["recent_len"] = jc["recent_len"] + 3
  tok = np.array([[5], [77]], np.int32)
  lg_j, st_j = jax.jit(j_make_serve_step(jcfg, mode="synopsis", i_max=2,
                                         impl="xla"))(jparams, jc,
                                                      jnp.asarray(tok))
  lg, st = make_serve_step(cfg, i_max=2)(params, tc,
                                         torch.from_numpy(tok).long())
  _close(lg, lg_j)
  for name in ("k_delta", "v_delta"):
    assert tuple(st[name].shape) == st_j[name].shape
    _close(st[name], st_j[name])
  np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(st_j["pos"]))
  with pytest.raises(ValueError, match="mode"):
    make_serve_step(cfg, mode="approx")


def test_serving_loop_generates_jax_token_ids(llama):
  jcfg, jparams, cfg, params, prompt, basis = llama
  want_ids, want_logits, jcache = _jax_loop(jcfg, jparams, prompt, BUDGETS)
  out = launch.run(cfg, batch=B, prompt_len=S, tokens=len(BUDGETS),
                   device="cpu", params=params,
                   prompt=torch.from_numpy(prompt).long(), budgets=BUDGETS,
                   pca_basis=torch.from_numpy(basis), log=lambda _: None)
  assert out["absorbs"] == 1 and out["budgets"] == BUDGETS
  np.testing.assert_array_equal(out["tokens"].numpy(), want_ids)
  for name in ("k", "k_syn", "counts", "recent_k", "recent_len"):
    assert tuple(out["cache"][name].shape) == jcache[name].shape, name
  _close(out["cache"]["k_syn"], jcache["k_syn"])


def test_launcher_cli_on_cpu(capsys):
  out = launch.main(["--device", "cpu", "--prompt-len", "64", "--tokens",
                     "3", "--budget", "1", "--batch", "1"])
  assert out["budgets"] == [1, 1, 1]
  assert tuple(out["tokens"].shape) == (1, 4)
  assert "generated:" in capsys.readouterr().out


def test_launcher_refuses_without_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(SystemExit) as e:
    launch.main(["--tokens", "1"])
  assert e.value.code != 0


def _imports(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_port_imports_neither_jax_nor_repro():
  files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
  files.append(ROOT / "chip_smoke.py")
  assert len(files) > 10
  for path in files:
    for mod in _imports(path):
      top = mod.split(".")[0]
      assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


def _run_smoke(cwd, script):
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["CUDA_VISIBLE_DEVICES"] = ""
  return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
  res = _run_smoke(ROOT, ROOT / "chip_smoke.py")
  assert res.returncode != 0
  assert '"ok"' not in res.stdout
  alone = tmp_path / "chip_smoke.py"
  shutil.copy(ROOT / "chip_smoke.py", alone)
  res = _run_smoke(tmp_path, alone)
  assert res.returncode != 0
  assert '"ok"' not in res.stdout
