from tpugan_torch.invert.edit import edit_latent, load_direction
from tpugan_torch.invert.embedding import EmbeddingConfig, InversionResult, make_embedder

__all__ = ["EmbeddingConfig", "InversionResult", "make_embedder", "edit_latent", "load_direction"]
