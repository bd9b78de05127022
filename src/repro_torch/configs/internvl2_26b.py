"""internvl2-26b: InternViT frontend (STUB patch embeddings) + InternLM2-20B
backbone. [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    act="swiglu",
    norm="rmsnorm",
    input_mode="embeds",
    fsdp=True,
    source="arXiv:2404.16821 (InternVL2); hf:OpenGVLab/InternVL2-26B",
)
