"""Gemma-3 12B [hf:google/gemma-3-1b-pt family] — dense decoder, 5:1
local:global sliding-window pattern (window 1024), dual rope thetas,
qk-norm, tied embeddings, 262k vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    sliding_window=1024,
    global_every=6,
    rope_theta=10_000.0,
    global_rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
