"""recurrentgemma-2b: RG-LRU + local attention (1 attn : 2 recurrent).
[arXiv:2402.19427 (Griffin)]"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    norm="rmsnorm",
    hybrid=HybridConfig(attn_period=3, local_window=2048, lru_width=2560,
                        conv_width=4),
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)
