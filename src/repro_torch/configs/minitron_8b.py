"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679].
Dense GQA decoder: 32L, d_model 4096, 32 heads (kv 8), d_ff 16384, vocab 256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=256000, activation="swiglu", rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    activation="swiglu", param_dtype="float32", compute_dtype="float32",
)
