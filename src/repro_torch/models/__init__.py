"""The LM scaffold of the port: config, layers, caches, MoE, SSM, decoder
assembly and serving (counterpart of `repro.models`)."""
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig"]
