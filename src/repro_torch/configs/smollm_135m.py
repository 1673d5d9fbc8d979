"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152 —
llama-arch small, tied embeddings.  [hf:HuggingFaceTB/SmolLM-135M; hf]

Published context 2048 positions; the full-width runs prefill 8192 (random
weights, so nothing is lost but realism).
"""
from repro_torch.models.common import LayerSpec, ModelConfig, SynopsisConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, head_dim=64,
    rope_theta=10000.0, tie_embeddings=True,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=3,
    d_ff=192, vocab=512, head_dim=32,
    rope_theta=10000.0, tie_embeddings=True,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
