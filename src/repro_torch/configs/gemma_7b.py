"""Gemma-7B [arXiv:2403.08295]. 28L, d_model 3072, 16 heads (MHA: kv 16),
head_dim 256, GeGLU d_ff 24576, vocab 256000, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", num_layers=28, d_model=3072,
    num_heads=16, num_kv_heads=16, head_dim=256, d_ff=24576,
    vocab_size=256000, activation="geglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke", family="dense", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
    activation="geglu", tie_embeddings=True,
    param_dtype="float32", compute_dtype="float32",
)
