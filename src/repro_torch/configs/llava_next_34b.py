"""llava-next-34b [vlm] yi-34b backbone + anyres patch-embedding stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000; 576 patch embeddings
prepended (frontend is a stub per assignment — input_specs provides them)."""
from repro_torch.configs.base import ATTN, ModelConfig, Segment

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    segments=(Segment((ATTN,), 60),),
    input_mode="tokens+image",
    n_prefix_embeds=576,
)
