"""The paper's own backbones (section 4): ViT-B/16 (85.8 M params) for the
image tasks and GPT-2 Small (124 M) for the text tasks, plus the reduced
variants of the CPU experiment harness.  The port's copy of
`src/repro/configs/paper_models.py`: module constants, not arch ids (the
reference does not list them in its registry either)."""
from repro_torch.models.config import ModelConfig

VIT_B16 = ModelConfig(
    name="vit-b16", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=1,
    activation="gelu", num_classes=10, embed_inputs=True,
    use_learned_pos=True, max_seq=197,
)

GPT2_SMALL = ModelConfig(
    name="gpt2-small", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=50257,
    activation="gelu", use_learned_pos=True, max_seq=1024,
    tie_embeddings=True,           # GPT-2 ties wte with the LM head (124M)
)

VIT_TINY = ModelConfig(
    name="vit-tiny", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=1,
    activation="gelu", num_classes=10, embed_inputs=True,
    use_learned_pos=True, max_seq=64,
    param_dtype="float32", compute_dtype="float32",
)

GPT_TINY = ModelConfig(
    name="gpt-tiny", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    activation="gelu", use_learned_pos=True, max_seq=256,
    param_dtype="float32", compute_dtype="float32",
)
