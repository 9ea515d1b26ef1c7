"""PyTorch / CUDA port of m_cedm_tpu for NVIDIA Hopper (H100).

The JAX package m_cedm_tpu stays the reference; this package mirrors its
module names (ops, data, models, samplers, physics, tasks) and never imports
JAX. The TPU's Pallas kernels on the training and serving paths, forward and
backward, are hand-written CUDA C++ for sm_90a under csrc/, wrapped in
m_cedm_tpu_torch.kernels. Entry points:

    from m_cedm_tpu_torch.tasks import build_task
    task = build_task(hparams, device)
    state = task.init_state(generator, norm_stats)
    state, metrics = task.train_step(state, batch, generator)
    metrics, hu_mean = task.eval_step(state, batch, generator, mask,
                                      split="test", mask_name="u")
"""
