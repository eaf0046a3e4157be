"""Hymba 1.5B [arXiv:2411.13676] — parallel attention + SSM heads per layer,
128 meta tokens, sliding-window attention with 3 global layers."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    block_kind="hymba",
    ssm_state=16,
    ssm_expand=2,
    n_meta_tokens=128,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    source="arXiv:2411.13676",
)
