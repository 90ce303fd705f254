from .gaussians import (
    GaussianParams,
    GaussianScene,
    from_numpy,
    pad_params_to,
    params_from_numpy,
)
from .losses import d_ssim_l1_loss, l1_loss, psnr, ssim
from .trainer import (
    TrainConfig,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "GaussianParams",
    "GaussianScene",
    "from_numpy",
    "pad_params_to",
    "params_from_numpy",
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "d_ssim_l1_loss",
    "l1_loss",
    "psnr",
    "ssim",
]
