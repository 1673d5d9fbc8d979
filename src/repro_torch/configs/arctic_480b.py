"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 in parallel with a dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]

One layer holds 128 experts x 3 x 7168 x 4864 = 13.39B parameters (26.8
GB in bf16), so the whole ~477B (~954 GB) does not fit one 80 GB card:
the full-width runs cut depth only, to 2 of the 35 layers
(``dataclasses.replace(CONFIG, n_layers=2)``, ~54.4 GB of layers); a
third layer would not fit.
"""
from repro_torch.models.common import (LayerSpec, ModelConfig, MoEConfig,
                                       SynopsisConfig)

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    rope_theta=10000.0,
    block_pattern=(LayerSpec(kind="attn", use_moe=True),),
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_parallel=True),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=32,
    rope_theta=10000.0,
    block_pattern=(LayerSpec(kind="attn", use_moe=True),),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  dense_parallel=True),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
