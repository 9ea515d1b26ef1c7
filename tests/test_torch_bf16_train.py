"""bf16 training of the ADM tasks against the JAX package: one train step of
McedmTask (ch 64, res 32, two levels, attention at 16x16, as
tests/test_torch_bf16_task.py builds it), of CondEdmTask (adm_edm_cond_h)
and of the ADM CondDdimTask (adm_cond_h; both at res 16, as
tests/test_torch_ddim_task.py builds them), each with JAX's draws injected,
against JAX's bf16 train_step on its default CPU route (XLA's bf16
autodiff, which rounds elsewhere than the Pallas kernels; the kernel-level
rounding is held in tests/test_torch_bf16_backward.py). The JAX step's
gradients are read out of its own jitted train_step (`_finish_step`
wrapped to return them), beside those of the fp32 task on the same state.

Held, for each task:
  - the loss and the global gradient norm (before clipping) within 2e-2 of
    JAX's bf16 step's, relative;
  - the gradients' gap to JAX's fp32 gradients, the mean over parameters of
    mean |g - g32| / max |g32|, at most 1.5 times JAX's bf16 gap (the port
    loses no more than the reference does; the attention's key bias, whose
    gradient is zero in exact arithmetic, is left out of the mean);
  - the params after the step within 2 lr of JAX's (Adam moves an entry by
    about lr whatever its gradient's size: PERF.md section 2);
  - the master params, the Adam moments and the EMA in fp32.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from m_cedm_tpu.config import to_dotdict
from m_cedm_tpu.tasks import McedmTask as JaxMcedmTask
from m_cedm_tpu_torch.convert import jax_params_to_state_dict, jax_train_state_to_torch
from m_cedm_tpu_torch.tasks import build_task
from test_torch_bf16_task import STATS, hparams, jax_state, swe_batch
from test_torch_ddim_task import JAX_TASKS, jax_train_draws as cond_draws, model_config
from test_torch_ddim_task import jax_state as cond_jax_state
from test_torch_ddim_task import swe_batch as cond_batch, train_keys
from test_torch_train import jax_train_draws
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_LOSS, GAP_RATIO = 2e-2, 1.5


def with_grads(jtask):
    """The JAX task with its _finish_step also returning the step's
    gradients in the metrics, out of the jitted train_step."""
    finish = jtask._finish_step

    def capture(state, grads, metrics):
        new_state, out = finish(state, grads, metrics)
        return new_state, {**out, "grads": grads}

    jtask._finish_step = capture
    return jtask


def gap(grads, ref):
    """Mean over parameters of mean |g - ref| / max |ref| (the key biases
    left out: their exact gradient is zero)."""
    keys = [k for k in ref if not k.endswith(".k.bias")]
    return float(np.mean([np.abs(np.asarray(grads[k], np.float64) - ref[k]).mean()
                          / np.abs(ref[k]).max() for k in keys]))


def np_grads(tree):
    return {k: v.numpy() for k, v in jax_params_to_state_dict(tree).items()}


def hold_step(task, state, tbatch, tdraws, j16, j32, jstate, jbatch, key, lr):
    """One bf16 train step of the port against JAX's (module docstring)."""
    new_j, m_j = j16.train_step(jstate, jbatch, key)
    _, m_32 = j32.train_step(jstate, jbatch, key)
    g16, g32 = np_grads(m_j["grads"]), np_grads(m_32["grads"])
    out = task.loss_and_grads(state, tbatch, None, **tdraws)
    loss = out[0] if isinstance(out[0], torch.Tensor) else out[0]["train_loss"]
    grads = {k: v.numpy() for k, v in out[1].items()}
    assert sorted(grads) == sorted(g16)
    assert all(v.dtype == np.float32 for v in grads.values())
    np.testing.assert_allclose(float(loss), float(m_j["train_loss"]), rtol=TOL_LOSS)
    norm_j = float(optax.global_norm(m_j["grads"]))
    norm_t = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                               for v in grads.values())))
    np.testing.assert_allclose(norm_t, norm_j, rtol=TOL_LOSS)
    gap_t, gap_j = gap(grads, g32), gap(g16, g32)
    print(f"gradient gap to fp32: port {gap_t:.3e}, JAX bf16 {gap_j:.3e}, "
          f"ratio {gap_t / gap_j:.3f}; loss {float(loss):.6f} / {float(m_j['train_loss']):.6f}; "
          f"norm {norm_t:.6f} / {norm_j:.6f}")
    assert gap_t <= GAP_RATIO * gap_j

    state, m_t = task.train_step(state, tbatch, None, **tdraws)
    np.testing.assert_allclose(float(m_t["train_loss"]), float(loss), rtol=0, atol=0)
    np.testing.assert_allclose(float(m_t["grad_norm"]), norm_t, rtol=1e-5)
    want = jax_train_state_to_torch(new_j)
    for k, p in want["params"].items():
        assert state.params[k].dtype == torch.float32, k
        assert state.ema_params[k].dtype == torch.float32, k
        for mom in ("mu", "nu"):
            assert state.opt_state[mom][k].dtype == torch.float32, k
        diff = np.abs(state.params[k].numpy() - p.numpy())
        assert diff.max() <= 2 * lr, k
    return state


def test_mcedm_bf16_train_step_matches_jax():
    j16 = with_grads(JaxMcedmTask(to_dotdict(hparams())))
    j32 = with_grads(JaxMcedmTask(to_dotdict(hparams("float32"))))
    jstate = jax_state(j32, 0)
    jstate = jstate.replace(opt_state=j32.tx.init(jstate.params))
    task = build_task(hparams(), "cpu")
    assert task.compute_dtype == torch.bfloat16
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    batch = swe_batch(5)
    key = jax.random.PRNGKey(11)
    res = batch[0].shape[1]
    draws = jax_train_draws(key, batch[0].shape[0], res)
    tdraws = {k: torch.from_numpy(v) for k, v in draws.items()}
    hold_step(task, state, tuple(map(torch.from_numpy, batch)), tdraws, j16, j32,
              jstate, tuple(map(jnp.asarray, batch)), key, 2e-4)


@pytest.mark.parametrize("name", ["adm_edm_cond_h_res32", "adm_cond_h_res32"])
def test_cond_bf16_train_step_matches_jax(name):
    """CondEdmTask and the ADM CondDdimTask: one bf16 step each."""
    target, hp = model_config(name)
    hp16 = copy.deepcopy(hp)
    hp16["model"]["dtype"] = "bfloat16"
    j16 = with_grads(JAX_TASKS[target](to_dotdict(copy.deepcopy(hp16))))
    j32 = with_grads(JAX_TASKS[target](to_dotdict(copy.deepcopy(hp))))
    jstate = cond_jax_state(j32, 0)
    task = build_task(hp16, "cpu", target=target)
    assert task.compute_dtype == torch.bfloat16
    state = task.init_state(None, STATS, **jax_train_state_to_torch(jstate))
    batch = cond_batch(1)
    (key,) = train_keys(j16, 1)
    draws = cond_draws(j16, key, batch[0].shape[0])
    hold_step(task, state, tuple(map(torch.from_numpy, batch)), draws, j16, j32,
              jstate, tuple(map(jnp.asarray, batch)), key, hp["optimization"]["lr"])
