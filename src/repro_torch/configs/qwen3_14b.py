"""qwen3-14b [dense]: 40L d=5120 40H kv=8 ff=17408, qk-norm.
[hf:Qwen/Qwen3-8B(family); hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0,
)
