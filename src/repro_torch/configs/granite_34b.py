"""granite-34b: dense code LM, llama-arch, MQA (GQA kv=1). [arXiv:2405.04324]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="swiglu",
    norm="rmsnorm",
    fsdp=True,
    source="arXiv:2405.04324 (Granite Code Models); hf",
)
