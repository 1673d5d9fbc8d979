"""deepseek-v2-236b [moe]: 60L d=5120 128H d_ff(expert)=1536 vocab=102400,
MoE 160e top-6 + 2 shared experts, MLA kv_lora=512 (the latent cache is a
learned synopsis; AccuracyTrader's clusters stack on top of it).
[arXiv:2405.04434; hf]

Every layer is an MoE layer here, as in the JAX package's config (the
published model's first layer is dense).  One layer holds 160 experts x 3
x 5120 x 1536 = 3.77B parameters (7.55 GB in bf16) beside ~0.2B of MLA
and shared-expert weights, so the whole ~236B (~472 GB) does not fit one
80 GB card: the full-width runs cut depth only, to 7 of the 60 layers
(``dataclasses.replace(CONFIG, n_layers=7)``, ~28.9B parameters, ~58.8 GB
with the f32 unembedding).

MLA's absorbed decode reads one key/value head of kv_lora + rope = 576
with all 128 query heads (G = 128); its prefill attends at qk_nope +
qk_rope = 192 with v zero-padded from 128 to 192.
"""
from repro_torch.models.common import (LayerSpec, MLAConfig, ModelConfig,
                                       MoEConfig, SynopsisConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=0, vocab=102400, head_dim=128,
    rope_theta=10000.0,
    block_pattern=(LayerSpec(kind="attn", use_moe=True),),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512, head_dim=32,
    rope_theta=10000.0,
    block_pattern=(LayerSpec(kind="attn", use_moe=True),),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, num_shared=1),
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                  qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
