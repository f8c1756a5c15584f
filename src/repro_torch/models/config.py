"""Model configuration: the port's own copy of the reference dataclasses.

Field for field the same as `src/repro/models/config.py`, so a reference
config converts with `ModelConfig(**dataclasses.asdict(cfg))`.  The port
builds only the dense `attn_mlp` block so far (`models/model.py` raises
for the other kinds); the fields of the other families stay so that every
config in the reference zoo still constructs.  `FederatedConfig` is the
reference's too (one FLASC round's geometry and optimizer settings).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Block kinds
ATTN_MLP = "attn_mlp"        # standard transformer block (attention + MLP)
ATTN_MOE = "attn_moe"        # attention + MoE FFN
MLSTM = "mlstm"              # xLSTM matrix-LSTM block
SLSTM = "slstm"              # xLSTM scalar-LSTM block (sequential)
HYBRID = "hybrid"            # Hymba-style parallel attention + Mamba heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                        # dense FFN width (0 for pure-SSM archs)
    vocab_size: int

    head_dim: Optional[int] = None   # default: d_model // num_heads
    activation: str = "swiglu"       # swiglu | geglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    sliding_window: Optional[int] = None

    # --- Multi-head Latent Attention (DeepSeek V2/V3) ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # --- SSM / xLSTM / hybrid ---
    ssm_state_size: int = 16
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    slstm_every: int = 0
    mlstm_chunk: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- VLM ---
    num_image_tokens: int = 0
    vision_embed_dim: int = 0

    # --- Multi-token prediction (DeepSeek V3) ---
    mtp_depth: int = 0

    # --- paper-experiment models (ViT classifier / GPT2-style LM) ---
    num_classes: int = 0
    use_learned_pos: bool = False
    max_seq: int = 0
    embed_inputs: bool = False

    # --- attention compute policy ---
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    chunked_attn_threshold: int = 8192  # chunked (flash-style) attn at/after this seq

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not (self.use_mla or self.num_heads % max(self.num_kv_heads, 1) == 0):
            raise ValueError(f"{self.name}: num_heads {self.num_heads} is not "
                             f"a multiple of num_kv_heads {self.num_kv_heads}")

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim

    @property
    def group_size(self) -> int:
        return self.num_heads // self.num_kv_heads

    def block_pattern(self) -> Tuple[str, ...]:
        """Periodic block-kind pattern (one period)."""
        if self.family in ("ssm",) and self.slstm_every:
            return tuple([MLSTM] * (self.slstm_every - 1) + [SLSTM])
        if self.family == "hybrid":
            return (HYBRID,)
        if self.num_experts > 0:
            return (ATTN_MOE,)
        return (ATTN_MLP,)

    def layer_groups(self) -> Sequence[Tuple[str, int]]:
        """(kind, count) groups, each stacked on a leading layer axis."""
        if self.num_experts > 0 and self.first_k_dense > 0:
            return [(ATTN_MLP, self.first_k_dense),
                    (ATTN_MOE, self.num_layers - self.first_k_dense)]
        pat = self.block_pattern()
        if len(pat) == 1:
            return [(pat[0], self.num_layers)]
        if self.num_layers % len(pat):
            raise ValueError(f"{self.name}: {self.num_layers} layers do not "
                             f"tile the block pattern {pat}")
        return [("period:" + ",".join(pat), self.num_layers // len(pat))]

    def param_count(self) -> int:
        from repro_torch.models.model import count_params  # lazy, avoids cycle
        return count_params(self)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # which linear maps get adapters; names match block param keys
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    dtype: str = "float32"

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """One FLASC round: federation geometry and optimizer settings."""
    n_clients: int = 16
    local_batch: int = 16
    local_steps: int = 1
    client_lr: float = 5e-4
    client_momentum: float = 0.9
    server_lr: float = 1e-3
    server_opt: str = "adam"         # adam (FedAdam) | sgd (FedAvg rule, Appx A)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    density_down: float = 0.25
    density_up: float = 0.25
    # differential privacy (0 => off)
    dp_clip: float = 0.0
    dp_noise: float = 0.0

    def split_batch(self, global_batch: int):
        n = min(self.n_clients, max(global_batch // self.local_batch, 1))
        lb = global_batch // n
        if n * lb != global_batch:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"into {n} clients of {lb}")
        return n, lb
