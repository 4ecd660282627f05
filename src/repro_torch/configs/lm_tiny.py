"""lm-tiny — CPU smoke/benchmark model (sub-1M params)."""
from repro_torch.configs.base import ATTN, ModelConfig, Segment

CONFIG = ModelConfig(
    name="lm-tiny",
    family="dense",
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    segments=(Segment((ATTN,), 2),),
    dtype="float32",
)
