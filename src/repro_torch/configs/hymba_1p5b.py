"""hymba-1.5b [hybrid]: 32L d=1600, PARALLEL attention + mamba heads in
every layer (outputs averaged), 25H GQA kv=5 (head_dim 64), ff=5504,
ssm_state=16. [arXiv:2411.13676; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_heads=25, ssm_head_dim=64,
    parallel_ssm=True,
)
