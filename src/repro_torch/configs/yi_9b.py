"""Yi-9B [arXiv:2403.04652]. Llama-arch GQA: 48L, d_model 4096, 32 heads
(kv 4), d_ff 11008, vocab 64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense", num_layers=48, d_model=4096,
    num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
    vocab_size=64000, activation="swiglu",
)

SMOKE = ModelConfig(
    name="yi-9b-smoke", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    activation="swiglu", param_dtype="float32", compute_dtype="float32",
)
