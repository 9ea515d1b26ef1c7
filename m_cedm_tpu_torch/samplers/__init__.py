from m_cedm_tpu_torch.samplers.edm import (
    EdmSchedule,
    heun_sample_masked,
    make_edm_schedule,
)
