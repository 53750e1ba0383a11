"""The learned models: the Zero-DCE-style curve CNN, the Retinex
decomposition net and the dilated FCN, each as a functional pair
(``init_*`` -> params dict, ``apply_*``) and as an ``nn.Module``; their
conv primitive and the shipped weights."""

from low_light_image_enhancement_tpu_torch.models.curve_cnn import (
    CurveEstimatorCNN,
    apply_curve_cnn,
    init_curve_cnn,
)
from low_light_image_enhancement_tpu_torch.models.decom import (
    DecomNet,
    apply_decom_net,
    init_decom_net,
)
from low_light_image_enhancement_tpu_torch.models.fcn import (
    EnhanceFCN,
    apply_fcn,
    init_fcn,
)

__all__ = [
    "CurveEstimatorCNN",
    "init_curve_cnn",
    "apply_curve_cnn",
    "DecomNet",
    "init_decom_net",
    "apply_decom_net",
    "EnhanceFCN",
    "init_fcn",
    "apply_fcn",
]
