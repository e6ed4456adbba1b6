from .diffwave import DiffWave
from .diffwave_fused import FusedDiffWave
from .sddm import SDDM, SDDM_spectrogram
from .unet_modified2 import UNetModified2

__all__ = ["SDDM", "DiffWave", "FusedDiffWave", "SDDM_spectrogram", "UNetModified2"]
