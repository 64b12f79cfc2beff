"""The matchers: config, layers, GM building blocks, DGNNS (IMP), AdaGMN (EIMP),
SuperGlue."""
from impx_torch.models.config import MatcherConfig
from impx_torch.models.adgm import AdaGMN
from impx_torch.models.dgnns import DGNNS
from impx_torch.models.superglue import SuperGlue

__all__ = ["MatcherConfig", "DGNNS", "AdaGMN", "SuperGlue"]
