from .sddm import SDDM
from .unet_modified2 import UNetModified2

__all__ = ["SDDM", "UNetModified2"]
