"""The dx pass of the bf16 K2 / K3 backward (`gn_dx`, whose plain version
`gn_dx_plain` the wrapper runs on the CPU) against the JAX package: alone
against `_dx_from_da` on the same bf16 x and da, and as the last step of the
port's split of each backward, against the Pallas kernels in interpret mode
on the same bf16 inputs (about 15 s in one process).

K2: the dgrad kernel stores da rounded to bf16 with fp32 (dgamma, dbeta)
beside it, as `_bwd_phase_a` does; `gn_dx_plain` of those is held to
`_pallas_gnsc_bwd`'s dx. K3: the dgrad kernel folds the 2 x 2 high-res block
of each low-res pixel and forms the fp32 da there (da = ds_low * silu'(a),
with dgamma, dbeta from it), where `_pallas_up_pair_bwd` folds in XLA and
keeps ds in fp32 through the low-res tail; `gn_dx_plain` of that fp32 da is
held to its dx. Tolerances as tests/test_torch_bf16_backward.py's: a bf16
output within 1e-2 of its scale at most and 1e-4 on average (one rounding,
whose last bit fp32 summation order can flip), the fp32 dgamma and dbeta
within 1e-5 of theirs (the same sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m_cedm_tpu.pallas.fused_norm as jfn
import m_cedm_tpu.pallas.fused_norm_conv as jfnc
from m_cedm_tpu_torch.kernels import fused_norm as tfn
from m_cedm_tpu_torch.kernels import fused_norm_conv as tfnc
from test_torch_bf16_kernels import EPS, bf16, held, jb, tb
from test_torch_bf16_kernels import interpret  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_F32 = 1e-5


def _vec(rs, b, c, scale, shift=0.0):
    return (shift + scale * rs.randn(b, c)).astype(np.float32)


def _sums(x):
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1, x.shape[-1])
    return x.sum(1).astype(np.float32), (x * x).sum(1).astype(np.float32)


def _held32(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_F32 * np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("da_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((3, 5, 7, 24), 4),
                                          ((1, 16, 12, 64), 16), ((2, 6, 10, 12), 3)])
def test_gn_dx_plain_matches_dx_from_da(shape, groups, da_dtype):
    """gn_dx_plain against _dx_from_da (one fused XLA pass on the TPU) on the
    same bf16 x, bf16 (K2) or fp32 (K3's tail) da and fp32 vectors."""
    rs = np.random.RandomState(sum(shape) + groups)
    b, c = shape[0], shape[-1]
    x = bf16(rs, *shape, scale=0.8, shift=0.2)
    da = (bf16(rs, *shape, scale=0.1) if da_dtype == "bf16"
          else (0.1 * rs.randn(*shape)).astype(np.float32))
    gamma = _vec(rs, b, c, 0.3, 1.0)
    dgamma, dbeta = _vec(rs, b, c, 30.0), _vec(rs, b, c, 30.0)
    sums, sumsq = _sums(x)
    n = int(np.prod(shape[1:-1]))
    jda = jb(da) if da_dtype == "bf16" else jnp.asarray(da)
    want = jfnc._dx_from_da(jb(x), jda, jnp.asarray(gamma), jnp.asarray(dgamma),
                            jnp.asarray(dbeta), jnp.asarray(sums), jnp.asarray(sumsq),
                            jnp.asarray(jfn._group_matrix(groups, c)), n, EPS)
    tda = tb(da) if da_dtype == "bf16" else _t(da)
    got = tfnc.gn_dx_plain(tb(x), tda, _t(gamma), torch.stack([_t(dgamma), _t(dbeta)]),
                           (_t(sums), _t(sumsq)), groups, EPS)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    held(got, want)
    # the wrapper on CPU tensors is the plain version
    torch.testing.assert_close(
        tfnc.gn_dx(tb(x), tda, _t(gamma), torch.stack([_t(dgamma), _t(dbeta)]),
                   (_t(sums), _t(sumsq)), groups, EPS), got, rtol=0, atol=0)


@pytest.mark.parametrize("b,res,c,o,groups", [(2, 16, 32, 32, 8), (1, 16, 16, 24, 4),
                                              (2, 8, 64, 32, 16)])
def test_k2_split_matches_bwd_phase_a_and_dx(interpret, b, res, c, o, groups):
    """K2's act mode split as the kernels run it: dgrad's da (rounded to
    bf16) and fp32 (dgamma, dbeta), then the dx pass; against
    _pallas_gnsc_bwd in interpret mode (phase A, then _dx_from_da)."""
    rs = np.random.RandomState(res * c + o)
    x = bf16(rs, b, res, res, c, scale=0.8, shift=0.2)
    g = bf16(rs, b, res, res, o)
    w = bf16(rs, 3, 3, c, o, scale=1.0 / np.sqrt(9 * c))
    gamma, beta = _vec(rs, b, c, 0.3, 1.0), _vec(rs, b, c, 0.3)
    sums, sumsq = _sums(x)
    js = (jnp.asarray(sums), jnp.asarray(sumsq))
    want = jfnc._pallas_gnsc_bwd(jb(x), jnp.asarray(gamma), jnp.asarray(beta),
                                 jnp.asarray(w), *js, jb(g), groups, EPS)
    # the dgrad kernel's epilogue: da = ds * silu'(a) in fp32, (dgamma,
    # dbeta) from it, da stored rounded
    stats = (_t(sums), _t(sumsq))
    mean, rstd = tfn.group_mean_rstd_from_sums(*stats, res * res, groups, EPS)
    xhat = (tb(x).float() - mean[:, None, None]) * rstd[:, None, None]
    a = xhat * _t(gamma)[:, None, None] + _t(beta)[:, None, None]
    da = tfnc.conv3x3_dgrad_plain(tb(g).float(), tb(w).float()) * tfn.silu_grad(a)
    dstats = torch.stack([(da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))])
    dx = tfnc.gn_dx_plain(tb(x), da.to(torch.bfloat16), _t(gamma), dstats, stats, groups,
                          EPS)
    held(dx, want[0])
    _held32(dstats[0], want[1])
    _held32(dstats[1], want[2])
    # the port's whole bf16 K2 backward (the CPU path) gives the same dx
    port = tfnc.gn_silu_conv_bwd_plain(tb(g), tb(x), _t(gamma), _t(beta), tb(w), groups, EPS,
                                       stats=stats)
    held(dx, port[0])


@pytest.mark.parametrize("b,res,c,o,groups", [(2, 8, 32, 32, 8), (1, 8, 16, 24, 4),
                                              (1, 16, 24, 16, 6)])
def test_k3_split_matches_up_pair_bwd(interpret, b, res, c, o, groups):
    """K3 split as the kernels run it: the dgrad kernel's 2 x 2 fold to the
    low-res pixel, da = ds_low * silu'(a) in fp32 with (dgamma, dbeta), then
    the dx pass of the fp32 da; against _pallas_up_pair_bwd in interpret
    mode (row fold and low-res tail in XLA)."""
    rs = np.random.RandomState(res * c + o + 1)
    x = bf16(rs, b, res, res, c, scale=0.8, shift=0.2)
    g = bf16(rs, b, 2 * res, 2 * res, o)
    w = bf16(rs, 3, 3, c, o, scale=1.0 / np.sqrt(9 * c))
    gamma, beta = _vec(rs, b, c, 0.3, 1.0), _vec(rs, b, c, 0.3)
    sums, sumsq = _sums(x)
    want = jfnc._pallas_up_pair_bwd(jb(x), jnp.asarray(gamma), jnp.asarray(beta),
                                    jnp.asarray(w), jnp.asarray(sums), jnp.asarray(sumsq),
                                    jfnc.pair_array(jb(g)), groups, EPS)
    stats = (_t(sums), _t(sumsq))
    mean, rstd = tfn.group_mean_rstd_from_sums(*stats, res * res, groups, EPS)
    ds = tfnc.conv3x3_dgrad_plain(tb(g).float(), tb(w).float())
    ds_low = ds.reshape(b, res, 2, res, 2, c).sum(dim=4).sum(dim=2)
    xhat = (tb(x).float() - mean[:, None, None]) * rstd[:, None, None]
    da = ds_low * tfn.silu_grad(xhat * _t(gamma)[:, None, None] + _t(beta)[:, None, None])
    dstats = torch.stack([(da * xhat).sum(dim=(1, 2)), da.sum(dim=(1, 2))])
    dx = tfnc.gn_dx_plain(tb(x), da, _t(gamma), dstats, stats, groups, EPS)
    assert dx.dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    held(dx, want[0])
    _held32(dstats[0], want[1])
    _held32(dstats[1], want[2])
