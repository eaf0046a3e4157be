"""HuBERT-XLarge [arXiv:2106.07447] — 48-layer encoder-only audio
transformer.

The conv/mel frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (dim 512); the model is the encoder and the
masked-prediction head over 504 cluster targets.  Its head dim is
1280 / 16 = 80.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    task="masked_lm",
    causal=False,
    mlp_act="gelu",
    frontend_dim=512,
    source="arXiv:2106.07447",
)
