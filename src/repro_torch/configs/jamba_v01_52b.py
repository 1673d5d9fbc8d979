"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave (1 attention
layer per 8, at position 4), MoE every other layer.  [arXiv:2403.19887;
hf:ai21labs/Jamba-v0.1]

The whole model is ~51.4B parameters (~103 GB in bf16) and does not fit
one 80 GB card: the full-width runs cut depth only, to 16 of the 32
layers (2 of the 4 eight-layer superblocks, ``dataclasses.replace(CONFIG,
n_layers=16)``).
"""
from repro_torch.models.common import (LayerSpec, ModelConfig, MoEConfig,
                                       SSMConfig, SynopsisConfig)

_PATTERN = tuple(
    LayerSpec(kind="attn" if i == 4 else "mamba", use_moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    rope_theta=10000.0,
    block_pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=128),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

_SMOKE_PATTERN = tuple(
    LayerSpec(kind="attn" if i == 0 else "mamba", use_moe=(i % 2 == 1))
    for i in range(2)
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    rope_theta=10000.0,
    block_pattern=_SMOKE_PATTERN,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
