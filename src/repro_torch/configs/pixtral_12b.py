"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 —
pixtral-ViT frontend (STUB: the prefill takes precomputed patch
embeddings) + mistral-nemo text backbone (H*hd = 4096 != d).
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.models.common import LayerSpec, ModelConfig, SynopsisConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1000000.0,
    frontend="vision_stub", frontend_tokens=256, frontend_dim=1024,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    rope_theta=1000000.0,
    frontend="vision_stub", frontend_tokens=8, frontend_dim=32,
    block_pattern=(LayerSpec(kind="attn"),),
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
