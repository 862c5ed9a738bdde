"""mamba2-2.7b [ssm]: 64L d_model=2560, attn-free SSD, state=128.
[arXiv:2405.21060; unverified]. d_inner = 2*d_model = 5120, headdim 64 ->
80 SSD heads; vocab 50280 (GPT-NeoX tokenizer, padded)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=50280,
    ssm_state=128, ssm_heads=80, ssm_head_dim=64,
    tie_embeddings=True,
)
