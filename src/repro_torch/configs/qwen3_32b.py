"""Qwen3-32B [hf:Qwen/Qwen3-8B family card]. 64L, d_model 5120, 64 heads
(kv 8, head_dim 128), d_ff 25600, QK-RMSNorm, vocab 151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=25600,
    vocab_size=151936, activation="swiglu", qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    activation="swiglu", qk_norm=True,
    param_dtype="float32", compute_dtype="float32",
)
