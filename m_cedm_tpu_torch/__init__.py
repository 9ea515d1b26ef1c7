"""PyTorch / CUDA port of m_cedm_tpu for NVIDIA Hopper (H100).

The JAX package m_cedm_tpu stays the reference; this package mirrors its
module names (ops, data, models, samplers, physics, tasks) and never imports
JAX. The TPU's Pallas kernels on the serving path are hand-written CUDA C++
for sm_90a under csrc/, wrapped in m_cedm_tpu_torch.kernels. Entry point:

    from m_cedm_tpu_torch.tasks import build_task
    task = build_task(hparams, device)
    metrics, hu_mean = task.eval_step(state, batch, generator, mask,
                                      split="test", mask_name="u")
"""
