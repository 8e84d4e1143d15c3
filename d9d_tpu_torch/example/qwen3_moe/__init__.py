"""The Qwen3-MoE examples through the port (twin of ``example/qwen3_moe``)."""
