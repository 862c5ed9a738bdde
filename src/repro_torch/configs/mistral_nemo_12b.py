"""mistral-nemo-12b [dense]: 40L d=5120 32H kv=8 ff=14336, head_dim 128,
128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    rope_theta=1000000.0,
)
