"""Plain PyTorch oracle of the flash attention kernel."""
from repro_torch.kernels.flash_attention.flash_attention import attention_ref

__all__ = ["attention_ref"]
