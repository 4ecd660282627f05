"""gemma3-12b [dense] 5 local : 1 global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144, sliding window 1024."""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig, Segment

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    segments=(Segment((ATTN_LOCAL,) * 5 + (ATTN,), 8),),
    act="geglu",
    tie_embeddings=True,
)
