"""lm-100m — the end-to-end example model (~100M params): a small llama-style
LM used by examples/train driver on CPU and in convergence benchmarks."""
from repro_torch.configs.base import ATTN, ModelConfig, Segment

CONFIG = ModelConfig(
    name="lm-100m",
    family="dense",
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=1792,
    vocab_size=32000,
    segments=(Segment((ATTN,), 12),),
    dtype="float32",
)
