"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) fine-grained MoE:
2 shared + 64 routed experts, top-6, expert width 1408.
[arXiv:2401.06066; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    num_experts=64, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1408,
)
