"""xLSTM 350M [arXiv:2405.04517] — 24 blocks, mLSTM with interspersed sLSTM
(1-in-6), matrix-memory recurrence, O(1) decode state."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_kind="xlstm",
    slstm_every=6,
    source="arXiv:2405.04517",
)
