"""Hymba-1.5B [arXiv:2411.13676]. Hybrid-head blocks: parallel attention
(sliding window 1024) + Mamba heads sharing the input, fused by per-path
norms + learned scalars. 32L, d_model 1600, 25 heads (kv 5, hd 64),
d_ff 5504, ssm_state 16, vocab 32001.  (Meta-tokens and the 3 global-attn
layers of the paper are simplified away, as in the reference.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504,
    vocab_size=32001, activation="swiglu", sliding_window=1024,
    ssm_state_size=16, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    activation="swiglu", sliding_window=16, ssm_state_size=8, ssm_expand=2,
    param_dtype="float32", compute_dtype="float32",
)
