from m_cedm_tpu_torch.physics.pde_loss import (
    DarcyLoss,
    SweFvLoss,
    flip_state,
    get_pde_loss_function,
)
