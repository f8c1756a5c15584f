"""xLSTM-1.3B [arXiv:2405.04517]. 48 blocks, d_model 2048, 4 heads,
mLSTM:sLSTM ratio 7:1 (one sLSTM block per period of 8), no separate FFN
for mLSTM blocks (projection factor 2 inside), vocab 50304."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    slstm_every=8, mlstm_chunk=64,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=512, slstm_every=2,
    mlstm_chunk=8, param_dtype="float32", compute_dtype="float32",
)
