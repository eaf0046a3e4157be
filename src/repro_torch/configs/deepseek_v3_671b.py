"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA attention (low-rank q/kv with
decoupled RoPE), MoE with 1 shared + 256 routed experts (top-8, sigmoid
gating).  MTP head is out of scope, as in the reference."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    source="arXiv:2412.19437",
)
