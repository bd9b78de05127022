"""musicgen-medium: decoder-only over EnCodec tokens; frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2306.05284]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    norm="layernorm",
    rotary_pct=0.0,       # musicgen uses learned/sinusoidal pos; stubbed as none
    input_mode="embeds",
    source="arXiv:2306.05284 (MusicGen); hf:facebook/musicgen-medium",
)
