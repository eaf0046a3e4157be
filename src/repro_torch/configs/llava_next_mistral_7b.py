"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The SigLIP/CLIP vision tower is a stub, as in the reference: a batch
carries anyres patch embeddings (2880 tokens, dim 1024); the model is the
projector MLP and the Mistral decoder that consumes them.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    task="vlm",
    frontend_dim=1024,
    n_frontend_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
