"""whisper-medium [audio]: enc-dec 24L each, d=1024 16H d_ff=4096
vocab=51865 — conv frontend is a STUB (the prefill takes precomputed
frame embeddings), GELU MLPs with biases.  [arXiv:2212.04356; unverified]
"""
from repro_torch.models.common import (EncoderConfig, LayerSpec, ModelConfig,
                                       SynopsisConfig)

CONFIG = ModelConfig(
    name="whisper-medium",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    rope_theta=10000.0, mlp_type="gelu", attn_bias=True,
    scale_embed=False,
    block_pattern=(LayerSpec(kind="attn", cross_attn=True),),
    encoder=EncoderConfig(n_layers=24, n_heads=16, d_ff=4096,
                          source_len=1500),
    frontend="audio_stub", frontend_dim=1024,
    synopsis=SynopsisConfig(cluster_size=128, i_max=32),
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512,
    rope_theta=10000.0, mlp_type="gelu", attn_bias=True,
    block_pattern=(LayerSpec(kind="attn", cross_attn=True),),
    encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=256, source_len=16),
    frontend="audio_stub", frontend_dim=32,
    synopsis=SynopsisConfig(cluster_size=16, i_max=2, recent=16),
)
