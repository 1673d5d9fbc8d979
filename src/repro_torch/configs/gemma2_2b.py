"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 —
local+global alternating attention, logit softcaps, sandwich norms,
sqrt(d) embedding scale, tied embeddings.  [arXiv:2408.00118; hf]
"""
from repro_torch.models.common import LayerSpec, ModelConfig, SynopsisConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    rope_theta=10000.0, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    sandwich_norm=True, scale_embed=True, tie_embeddings=True,
    block_pattern=(LayerSpec(kind="attn", local=True),
                   LayerSpec(kind="attn")),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    rope_theta=10000.0, sliding_window=16,
    attn_softcap=50.0, logit_softcap=30.0,
    sandwich_norm=True, scale_embed=True, tie_embeddings=True,
    block_pattern=(LayerSpec(kind="attn", local=True),
                   LayerSpec(kind="attn")),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
