"""rwkv6-7b (Finch): attention-free SSM, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # head dim 64 (d_model / 64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    act="relu2",         # rwkv channel-mix uses squared relu
    norm="layernorm",
    source="arXiv:2404.05892 (Eagle & Finch); hf",
)
