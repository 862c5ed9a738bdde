"""whisper-base [audio]: enc-dec 6L+6L d=512 8H ff=2048 vocab 51865; conv/mel
frontend STUB — input_specs provides precomputed frame embeddings for the
encoder. [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    encoder_layers=6, frame_input=True,
)
