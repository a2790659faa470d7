from .cs_recon import fista_cs_mri, fista_inpaint, fista_inpaint_split, ista_step
from .denoise import denoise, hard_threshold, soft_threshold, soft_threshold_mag_pair

__all__ = [
    "denoise",
    "fista_cs_mri",
    "fista_inpaint",
    "fista_inpaint_split",
    "hard_threshold",
    "ista_step",
    "soft_threshold",
    "soft_threshold_mag_pair",
]
