"""``repro_torch.launch.parity`` on the CPU, at every (arch, mode, quant)
that ``chip_smoke.py`` and ``tests/test_torch_card.py`` hold card against
CPU.  Its float64 reference runs the same loop's plain versions in
float64, so a path that cannot run in float64 shows here, not on the card.
With the CPU in the card's place the two f32 loops give the same bits, and
the bound is TOL or GAP_MULT times the f32 loop's distance from float64.
A loop that rounds one tensor of the path through bf16 falls outside that
bound, even whisper-medium's, the loosest.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.launch import parity
from repro_torch.launch import serve

RUNS = ([("gemma2-2b", m, q) for m, q in (
    ("synopsis", "none"), ("exact", "none"), ("synopsis", "int8"),
    ("synopsis", "fp8"))]
    + [(a, m, "none") for a in ("smollm-135m", "pixtral-12b")
       for m in ("synopsis", "exact")]
    + [("whisper-medium", m, q) for m, q in (
        ("synopsis", "none"), ("exact", "none"), ("synopsis", "int8+kv"))]
    + [(a, m, "none") for a in ("jamba-v0.1-52b", "arctic-480b",
                                "command-r-plus-104b", "deepseek-v2-236b")
       for m in ("synopsis", "exact")]
    + [("mamba2-370m", "exact", "none")])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.mark.parametrize("arch,mode,quant", RUNS)
def test_loop_parity_on_the_cpu(arch, mode, quant):
  launched, rel, bound = parity.loop_parity(arch, "cpu", mode, quant)
  assert not any(launched.values())
  assert rel == 0.0
  assert bound >= parity.TOL
  # whisper-medium's SMOKE loop is the ill-conditioned one
  # (tests/test_torch_whisper.py::test_smoke_loop_f32_floor).
  if arch == "whisper-medium":
    assert bound > parity.TOL


def _bf16(t):
  return t.to(torch.bfloat16).to(t.dtype)


_PREFILL, _DECODE = ref.flash_prefill_ref, ref.flash_decode_ref
ROUNDINGS = {
    "prefill_out": ("flash_prefill_ref",
                    lambda q, k, v, **kw: _bf16(_PREFILL(q, k, v, **kw))),
    "decode_v": ("flash_decode_ref",
                 lambda q, k, v, *a, **kw: _DECODE(q, k, _bf16(v), *a, **kw)),
}


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("mode", ["synopsis", "exact"])
def test_bound_refuses_a_bf16_rounding(monkeypatch, mode, rounding):
  """whisper-medium's SMOKE loop with one plain version rounding a tensor
  through bf16 (eps 2^-8, the f32 loop's 2^-24): other ids, or logits
  beyond ten times the parity bound the same loop gets."""
  cfg, p32 = parity.smoke_f32("whisper-medium")
  prompt = torch.randint(0, cfg.vocab, (2, parity.PROMPT),
                         generator=torch.Generator().manual_seed(3))

  def run(c, p):
    return serve.run(c, batch=2, prompt_len=parity.PROMPT,
                     tokens=parity.TOKENS, device="cpu", params=p,
                     prompt=prompt, budgets=parity.BUDGETS
                     if mode == "synopsis" else None, mode=mode,
                     keep_logits=True, log=lambda _: None)
  cpu = run(cfg, p32)
  f64 = run(dataclasses.replace(cfg, dtype=torch.float64),
            parity.tree_to(p32, torch.float64))
  bound = max(parity.TOL, parity.GAP_MULT * parity.step_rel(cpu, f64))
  monkeypatch.setattr(ref, *ROUNDINGS[rounding])
  bad = run(cfg, p32)
  assert not torch.equal(bad["tokens"], cpu["tokens"]) or \
      parity.step_rel(bad, cpu) > 10 * bound
