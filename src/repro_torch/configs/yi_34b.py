"""yi-34b [dense] llama-arch GQA. [arXiv:2403.04652; hf]
60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000."""
from repro_torch.configs.base import ATTN, ModelConfig, Segment

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    segments=(Segment((ATTN,), 60),),
)
