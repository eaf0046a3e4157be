"""Architecture and input-shape schema of the model zoo — the port of
``repro.configs.base``, with torch dtypes in place of the JAX ones."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "reduced"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One selectable architecture (``--arch <name>``).

    ``block_kind`` picks the layer family:
      transformer — (GQA|MLA) attention + (dense|MoE) MLP
      xlstm       — mLSTM/sLSTM blocks
      hymba       — parallel attention + SSM heads, meta tokens
    ``task`` picks the loss/inputs: lm | masked_lm (audio) | vlm.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    block_kind: str = "transformer"
    task: str = "lm"
    causal: bool = True
    # --- attention ---
    attn_type: str = "gqa"  # gqa | mla
    rope_theta: float = 10_000.0
    global_rope_theta: float = 0.0  # gemma3: separate theta for global layers
    # per-layer sliding window: (local_window, global_every) — every
    # ``global_every``-th layer is global (window 0 = unbounded).
    sliding_window: int = 0
    global_every: int = 0
    global_layers: tuple = ()  # explicit full-attention layer indices (hymba)
    qk_norm: bool = False
    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    mlp_act: str = "swiglu"  # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gshard"  # gshard (capacity einsum) | dense (exact ref)
    # position-in-expert computation inside the gshard dispatch:
    #   "cumsum" — one-hot cumsum over (B, S*k, E): simple but O(T*E) memory
    #   "sort"   — stable argsort + per-expert offsets: O(T) memory
    moe_pos: str = "cumsum"
    # dtype of the dispatch/combine one-hot tensors ("f32" | "bf16")
    moe_dispatch_dtype: str = "f32"
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 1
    n_meta_tokens: int = 0
    slstm_every: int = 0  # xlstm: every k-th layer is sLSTM (0 = none)
    # --- vlm / audio stubs ---
    frontend_dim: int = 0  # patch/frame embedding dim provided by the stub
    n_frontend_tokens: int = 0
    # --- numerics / runtime ---
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # The reference's lax.scan unroll factor for the layer stack, kept so
    # that both packages' configs carry the same fields; the port's stack is
    # a Python loop and does not read it.
    scan_unroll: int = 1
    # Sharding policy when n_heads is indivisible by the model axis:
    #   "head_dim"  — shard the head_dim (contraction) dim: keeps params
    #                 sharded but forces per-layer score all-reduces.
    #   "replicate" — keep attention weights replicated over "model";
    #                 attention runs data-parallel, only the MLP is TP.
    attn_fallback: str = "head_dim"
    # KV-cache sharding for serving:
    #   "heads" — shard kv_heads/head_dim over "model" (baseline)
    #   "seq"   — shard the cache sequence dim over "model": attention
    #             reduces over the sharded axis with tiny (B,H,hd)
    #             all-reduces — distributed flash-decode.
    serve_cache_shard: str = "heads"
    tie_embeddings: bool = False
    fsdp: bool = True
    remat: bool = True
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def window_for_layer(self, i: int) -> int:
        """0 means full attention."""
        if not self.sliding_window:
            return 0
        if i in self.global_layers:
            return 0
        if self.global_every and (i + 1) % self.global_every == 0:
            return 0
        return self.sliding_window

    def supports_decode(self) -> bool:
        return self.causal

    def supports_long_context(self) -> bool:
        """Sub-quadratic per-token decode state (task-spec long_500k gate)."""
        if self.block_kind in ("xlstm", "hymba"):
            return True
        return bool(self.sliding_window)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test variant: 2 layers, d_model<=512, <=4 experts — same family."""
    small: dict = dict(
        n_layers=2 if not cfg.slstm_every else 2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64 if cfg.head_dim else 0,
        dtype=torch.float32,
        fsdp=False,
        remat=False,
    )
    if cfg.n_experts:
        small.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2))
    if cfg.q_lora_rank:
        small.update(
            q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
            qk_nope_head_dim=32, v_head_dim=32,
        )
    if cfg.sliding_window:
        small.update(sliding_window=32, global_every=min(cfg.global_every, 2))
    if cfg.n_meta_tokens:
        small.update(n_meta_tokens=8)
    if cfg.slstm_every:
        small.update(slstm_every=2)
    if cfg.frontend_dim:
        small.update(frontend_dim=min(cfg.frontend_dim, 64),
                     n_frontend_tokens=min(cfg.n_frontend_tokens, 16))
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
