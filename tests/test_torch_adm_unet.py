"""Port parity of the ADM U-Net: convert.py plus the full forward and the
input gradient against the JAX AdmUNet, with every parameter replaced by
seeded non-zero values (a fresh ADM init zeroes conv1, proj and out_conv,
so the net would return a constant whatever its kernels did).

Both configs use ch 64 (the single 64-wide attention head) and B = 2:
  res 32, attention at 8:  the JAX side runs its unpaired, stats-chained path;
  res 64, attention at 16: min_res % 16 == 0 puts the JAX side on its paired
                           composition (adm_unet.py:591-599).
On the CPU both sides run their plain math. Tolerance: 1e-5 of the output's
scale for the forward (fp32 summation order over ~25 layers; measured about
2e-6), 1e-4 for the input gradient, under the 1e-3 ceiling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m_cedm_tpu.models.adm_unet import AdmUNet as JaxUNet
from m_cedm_tpu.models.adm_unet import AdmUNetConfig as JaxConfig
from m_cedm_tpu_torch.convert import jax_params_to_state_dict
from m_cedm_tpu_torch.models import build_backbone
from m_cedm_tpu_torch.models.adm_unet import AdmUNet, AdmUNetConfig

B = 2
CONFIGS = {"res32-attn8": (32, 8), "res64-attn16-paired": (64, 16)}


def _kw(res, attn):
    return dict(in_channels=2, out_ch=2, ch=64, ch_mult=(1, 1, 1),
                num_res_blocks=1, attn_resolutions=(attn,), resolution=res,
                cond_channels=2, cat_cond=True)


def seeded_jax_params(params, seed):
    """Fan-in-scaled normals for every leaf; norm scales around 1."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if a.ndim > 1:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.3 * rs.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    res, attn = CONFIGS[request.param]
    rs = np.random.RandomState(res)
    x = rs.randn(B, res, res, 2).astype(np.float32)
    cond = rs.randn(B, res, res, 2).astype(np.float32)
    sigma = rs.uniform(-1.5, 1.0, B).astype(np.float32)
    jm = JaxUNet(JaxConfig(**_kw(res, attn)))
    # the tree's shapes only (a traced init would compile for seconds)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(sigma), jnp.asarray(cond))
    params = seeded_jax_params(shapes, res)
    tm = AdmUNet(AdmUNetConfig(**_kw(res, attn)))
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jm, params, tm, (x, sigma, cond)


def test_convert_maps_every_leaf(pair):
    _, params, tm, _ = pair
    leaves = jax.tree_util.tree_leaves(params)
    sd = jax_params_to_state_dict(params)
    assert len(sd) == len(leaves) == len(tm.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(np.size(a) for a in leaves)
    # the first decoder block at the attention resolution holds every leaf
    # kind: norms, 3x3 convs, the FiLM Linear, the 1x1 skip, attention
    attn = tm.cfg.attn_resolutions[0]
    blk = params["params"][f"dec_{attn}x{attn}_block0"]
    mapped = jax_params_to_state_dict({"params": {"b": blk}})
    np.testing.assert_array_equal(mapped["b.conv0.weight"].numpy(), blk["conv0"]["kernel"])
    np.testing.assert_array_equal(mapped["b.affine.weight"].numpy(),
                                  np.asarray(blk["affine"]["kernel"]).T)
    np.testing.assert_array_equal(mapped["b.skip.weight"].numpy(),
                                  np.asarray(blk["skip"]["kernel"])[0, 0])
    np.testing.assert_array_equal(mapped["b.attn_norm.weight"].numpy(),
                                  blk["GroupNorm_0"]["scale"])
    for leaf in ("qkv", "proj"):
        np.testing.assert_array_equal(mapped[f"b.{leaf}.weight"].numpy(),
                                      np.asarray(blk[leaf]["kernel"])[0, 0])


def test_forward_parity(pair):
    jm, params, tm, (x, sigma, cond) = pair
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(sigma),
                                        jnp.asarray(cond)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(sigma),
                 torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == x.shape
    scale = np.abs(want).max()
    assert scale > 0.1  # the seeded params make the output non-trivial
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_input_gradient_parity(pair):
    jm, params, tm, (x, sigma, cond) = pair
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def f(xx, cc):
        return jnp.sum(jm.apply(params, xx, jnp.asarray(sigma), cc) * g)

    gx_j, gc_j = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(cond))
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cond).requires_grad_(True)
    (tm(xt, torch.from_numpy(sigma), ct) * torch.from_numpy(g)).sum().backward()
    for got, want in ((xt.grad, gx_j), (ct.grad, gc_j)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_fresh_init_zeroes_output_convs():
    """The trap every parity check avoids: the ADM init zeroes conv1, proj
    and out_conv, so a fresh net's output is exactly zero."""
    tm = AdmUNet(AdmUNetConfig(**_kw(32, 8)))
    tm.reset_parameters(torch.Generator().manual_seed(0))
    zero = [n for n, p in tm.named_parameters() if not p.detach().abs().max()]
    assert "out_conv.weight" in zero and "enc_8x8_block0.proj.weight" in zero
    assert any(n.endswith("conv1.weight") for n in zero)
    bound = np.sqrt(3 / (64 * 9)) * 3 ** -0.5  # kaiming_uniform * init_weight
    w = tm.enc_32x32_block0.conv0.weight.detach()
    assert 0.9 * bound < float(w.abs().max()) <= bound
    with torch.no_grad():
        out = tm(torch.randn(1, 32, 32, 2), torch.zeros(1), torch.randn(1, 32, 32, 2))
    assert not out.abs().max()


@pytest.mark.parametrize("override", [{"self_cond": True}, {"dx_cond": True},
                                      {"cat_cond": False}, {"name": "ddpm"}])
def test_unported_inputs_raise(override):
    hp = {"name": "adm_edm_mcedm", "model": dict(_kw(32, 8), ch_mult=[1, 1, 1],
                                                 attn_resolutions=[8])}
    if "name" in override:
        hp["name"] = override["name"]
    else:
        hp["model"].update(override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_backbone(hp)
