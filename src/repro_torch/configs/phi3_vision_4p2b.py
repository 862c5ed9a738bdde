"""phi-3-vision-4.2b [vlm]: phi3-mini backbone (32L d=3072 32H kv=32
ff=8192) + CLIP tower STUB: input_specs provides 1024 precomputed patch
embeddings prepended to the text sequence.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    num_patches=1024,
)
