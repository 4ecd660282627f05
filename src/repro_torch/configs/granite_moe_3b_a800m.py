"""granite-moe-3b-a800m [moe] 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
32L d_model=1536 24H (kv=8) d_expert=512 vocab=49155."""
from repro_torch.configs.base import ATTN, MoEConfig, ModelConfig, Segment

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=49155,
    segments=(Segment((ATTN,), 32),),
    moe=MoEConfig(n_experts=40, n_experts_pad=48, top_k=8, d_expert=512,
                  capacity_factor=1.25),
    tie_embeddings=True,
)
