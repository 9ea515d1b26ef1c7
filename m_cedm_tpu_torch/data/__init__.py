from m_cedm_tpu_torch.data import masks
