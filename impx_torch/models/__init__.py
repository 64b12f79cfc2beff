"""The matchers: config, layers, GM building blocks, DGNNS (IMP), AdaGMN (EIMP),
SuperGlue; the SuperPoint detector and descriptor."""
from impx_torch.models.config import MatcherConfig
from impx_torch.models.adgm import AdaGMN
from impx_torch.models.dgnns import DGNNS
from impx_torch.models.superglue import SuperGlue
from impx_torch.models.superpoint import SuperPoint

__all__ = ["MatcherConfig", "DGNNS", "AdaGMN", "SuperGlue", "SuperPoint"]
