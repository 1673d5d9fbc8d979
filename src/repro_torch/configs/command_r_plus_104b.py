"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias, parallel attn+FFN blocks, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

One layer is 0.33B of attention and 1.25B of MLP (3.15 GB in bf16), so
the whole ~104B (~208 GB) does not fit one 80 GB card: the full-width
runs cut depth only, to 12 of the 64 layers
(``dataclasses.replace(CONFIG, n_layers=12)``, 37.8 GB of layers, plus
the 6.3 GB tied embedding and its 12.6 GB f32 unembedding).  G = 96 / 8
= 12 query heads share a KV head.
"""
from repro_torch.models.common import LayerSpec, ModelConfig, SynopsisConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
    rope_theta=75000.0, parallel_block=True, tie_embeddings=True,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=128, i_max=64),
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    rope_theta=75000.0, parallel_block=True, tie_embeddings=True,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
