"""DBRX 132B [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    source="hf:databricks/dbrx-base",
)
