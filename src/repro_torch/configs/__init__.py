"""Per-architecture configs and their registry (see ``base.ARCH_IDS``)."""
from repro_torch.configs.base import ARCH_IDS, Cell, get_arch

__all__ = ["ARCH_IDS", "Cell", "get_arch"]
