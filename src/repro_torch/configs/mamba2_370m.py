"""mamba2-370m [ssm]: 48L d=1024 attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality).  The synopsis has nothing to
work on (no KV cache): the loop runs it in exact mode and the engine
refuses it, as in the JAX package.  [arXiv:2405.21060]
"""
from repro_torch.models.common import (LayerSpec, ModelConfig, SSMConfig,
                                       SynopsisConfig)

CONFIG = ModelConfig(
    name="mamba2-370m",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    block_pattern=(LayerSpec(kind="mamba"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
    synopsis=SynopsisConfig(cluster_size=128, i_max=0),
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    n_layers=2, d_model=128, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=512,
    block_pattern=(LayerSpec(kind="mamba"),),
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32, chunk=32),
    tie_embeddings=True,
    synopsis=SynopsisConfig(cluster_size=16, i_max=0, recent=16),
)
