"""The matcher: config, layers, GM building blocks, DGNNS (IMP), AdaGMN (EIMP)."""
from impx_torch.models.config import MatcherConfig
from impx_torch.models.adgm import AdaGMN
from impx_torch.models.dgnns import DGNNS

__all__ = ["MatcherConfig", "DGNNS", "AdaGMN"]
