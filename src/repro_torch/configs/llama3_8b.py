"""llama3-8b [dense]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 —
GQA, 128k vocab, rope theta 500k.  [arXiv:2407.21783]
"""
from repro_torch.models.common import LayerSpec, ModelConfig, SynopsisConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    rope_theta=500000.0,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    rope_theta=500000.0,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
