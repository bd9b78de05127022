"""nemotron-4-340b: dense GQA kv=8, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    act="relu2",
    norm="layernorm",
    rope_theta=10000.0,
    fsdp=True,
    source="arXiv:2402.16819 (Nemotron-4 340B); unverified",
)
