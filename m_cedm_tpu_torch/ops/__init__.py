from m_cedm_tpu_torch.ops import losses
from m_cedm_tpu_torch.ops.normalizer import Normalizer
from m_cedm_tpu_torch.ops.schedules import (
    cosine_onecycle,
    edm_loss_weight,
    edm_precond_coeffs,
    edm_train_sigma,
    fourier_positional_embedding,
    get_beta_schedule,
    karras_sigma_grid,
    sinusoidal_timestep_embedding,
)
