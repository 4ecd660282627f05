"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]  48L d_model=1536 24H(MHA) d_ff=6144 vocab=2048.
Modality frontend is a stub: input_specs feeds precomputed frame embeddings
(backbone-only per assignment); the LM head predicts EnCodec codes."""
from repro_torch.configs.base import ATTN, ModelConfig, Segment

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    segments=(Segment((ATTN,), 48),),
    act="gelu",
    input_mode="embeddings",
)
