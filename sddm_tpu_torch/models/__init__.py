from .diffwave import DiffWave
from .diffwave_fused import FusedDiffWave
from .sddm import SDDM, SDDM_spectrogram
from .unet_modified2 import UNetModified2
from .unet_packed import PackedUNetModified2

__all__ = ["SDDM", "DiffWave", "FusedDiffWave", "PackedUNetModified2", "SDDM_spectrogram",
           "UNetModified2"]
