"""LM model code of the port (``repro.models``): layers, attention, moe, rglru, rwkv6, transformer."""
