"""llama4-maverick-400b-a17b: MoE 128 experts top-1 + shared expert,
GQA kv=8. [hf:meta-llama/Llama-4 family]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=128, experts_per_token=1, d_ff_expert=8192,
                  shared_expert=True),
    fsdp=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family); unverified",
)
