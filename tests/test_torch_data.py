"""The port's data modules against the JAX package's, on h5 fixtures written
by m_cedm_tpu.data.synthetic (res 16): the trajectory store read bit for bit,
the norm stats (flip_xy too), the batch order and content of every split from
one numpy seed, the eval masks of the mask datamodules, the down_factor
resize against jax.image.resize, and the OFormer's tokens.

The resize is held to 1e-6 of max(1, max|jax|): the port computes in
float64 and rounds once, jax.image.resize in float32 (a few ulp).
"""
import os

import jax
import jax.image
import numpy as np
import pytest

from m_cedm_tpu.data import datamodule as jdm
from m_cedm_tpu.data import h5_io as jh5
from m_cedm_tpu.data import oformer_data as joformer
from m_cedm_tpu.data.synthetic import write_swe_dataset
from m_cedm_tpu_torch.data import datamodule as tdm
from m_cedm_tpu_torch.data import h5_io as th5
from m_cedm_tpu_torch.data import oformer_data as toformer

RES = 16
TOL_RESIZE = 1e-6
# the flagship's datamodule_mcedm.yaml flags
MCEDM_FLAGS = dict(return_abs_coords=True, return_grid=True, norm_x=True,
                   norm_t=True, norm_input=False, norm_target=False)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5")
    train, test = str(root / "train.h5"), str(root / "test.h5")
    write_swe_dataset(train, jax.random.PRNGKey(0), 10, RES, RES)
    write_swe_dataset(test, jax.random.PRNGKey(1), 5, RES, RES, seed_offset=1000)
    return {"train_path": train, "val_path": test, "test_path": test}


def assert_resized_close(got, want):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL_RESIZE * max(1.0, np.abs(want).max()), err


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_read_store_bit_equal(paths):
    got, want = th5.read_store(paths["train_path"]), jh5.read_store(paths["train_path"])
    for name in ("inputs", "targets", "x", "t"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.attrs.keys() == want.attrs.keys()
    for k in want.attrs:
        np.testing.assert_array_equal(got.attrs[k], want.attrs[k])
    assert got.consts.keys() == want.consts.keys()


def test_port_write_store_reads_back_in_jax(tmp_path):
    rs = np.random.RandomState(0)
    inp, tar = rs.randn(3, 4, 5, 1), rs.randn(3, 4, 5, 1)
    x, t = np.linspace(0, 1, 5), np.linspace(0, 1, 4)
    path = str(tmp_path / "s.h5")
    th5.write_store(path, inp, tar, x, t, consts={"g": np.arange(3.0)})
    got = jh5.read_store(path)
    np.testing.assert_array_equal(got.inputs, inp.astype(np.float32))
    np.testing.assert_array_equal(got.consts["g"], np.arange(3.0, dtype=np.float32))
    assert float(got.attrs["tar_std"]) == np.float32(tar.std())


@pytest.mark.parametrize("flip_xy", [False, True])
@pytest.mark.parametrize("const_norm_stats", [True, False])
def test_norm_stats_equal(paths, flip_xy, const_norm_stats):
    kw = dict(paths, flip_xy=flip_xy, const_norm_stats=const_norm_stats)
    got = tdm.HDF5Datamodule(**kw).get_norm_stats()
    want = jdm.HDF5Datamodule(**kw).get_norm_stats()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("flags", [MCEDM_FLAGS, {}, dict(return_abs_coords=True),
                                   dict(use_tar_ic=True, flip_xy=True)],
                         ids=["mcedm", "spacings", "abs_coords", "tar_ic_flip"])
def test_batches_equal_in_order(paths, flags):
    kw = dict(paths, batch_size=4, **flags)
    got_dm, want_dm = tdm.HDF5MaskDatamodule(**kw), jdm.HDF5MaskDatamodule(**kw)
    for split in ("train", "val", "test"):
        assert got_dm.num_batches(split) == want_dm.num_batches(split)
        rng_seed = 1 if split == "train" else None

        def batches(dm):
            rng = None if rng_seed is None else np.random.default_rng(rng_seed)
            return list(dm.iter_split(split, rng))

        assert_batches_equal(batches(got_dm), batches(want_dm))


@pytest.mark.parametrize("cls,kw", [
    ("HDF5MaskDatamodule", {}),
    ("HDF5TimeMaskDatamodule", {"add_time_masks": False}),
    ("HDF5TimeMaskDatamodule", {"add_time_masks": True}),
    ("HDF5SparseMaskDatamodule", {"add_res_masks": False}),
    ("HDF5SparseMaskDatamodule", {"add_res_masks": True}),
])
def test_eval_masks_equal(paths, cls, kw):
    got = getattr(tdm, cls)(**paths, **kw)
    want = getattr(jdm, cls)(**paths, **kw)
    assert got.train_mask_kind == want.train_mask_kind
    gm, wm = got.eval_masks("test"), want.eval_masks("test")
    assert list(gm) == list(wm)
    for name in wm:
        np.testing.assert_array_equal(gm[name], np.asarray(wm[name]))
    with pytest.raises(NotImplementedError):
        tdm.HDF5Datamodule(**paths).eval_masks()


@pytest.mark.parametrize("shape_in,shape_out", [((4, 4, 2), (16, 16, 2)),
                                                 ((5, 3, 1), (16, 11, 1)),
                                                 ((16, 16, 2), (8, 8, 2)),
                                                 ((16, 12, 1), (5, 3, 1))])
def test_bilinear_resize_matches_jax_image_resize(shape_in, shape_out):
    """Up and down, at sizes that are not multiples, so that the border rows
    (renormalised weights) are covered."""
    a = np.random.RandomState(0).randn(2, *shape_in).astype(np.float32)
    got = tdm._bilinear_resize(a, *shape_out[:2])
    want = np.stack([np.asarray(jax.image.resize(s, shape_out, "bilinear",
                                                 antialias=False)) for s in a])
    assert got.shape == want.shape
    assert_resized_close(got, want)
    row = a[:, :, 0, 0]
    assert_resized_close(
        tdm._linear_resize_1d(row, shape_out[0]),
        np.stack([np.asarray(jax.image.resize(r, shape_out[:1], "linear",
                                              antialias=False)) for r in row]))


@pytest.mark.parametrize("down_interp", [True, False])
def test_down_factor_matches_jax(paths, down_interp):
    kw = dict(paths, batch_size=4, down_factor=2, down_interp=down_interp,
              **MCEDM_FLAGS)
    got = list(tdm.HDF5MaskDatamodule(**kw).iter_split("test"))
    want = list(jdm.HDF5MaskDatamodule(**kw).iter_split("test"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            assert_resized_close(a, b)
    # the train split is never resized
    assert_batches_equal(list(tdm.HDF5MaskDatamodule(**kw).iter_split("train")),
                         list(jdm.HDF5MaskDatamodule(**kw).iter_split("train")))


@pytest.mark.parametrize("down_factor", [1, 2])
def test_oformer_tokens_equal(paths, down_factor):
    kw = dict(paths, batch_size=4, return_abs_coords=True, norm_x=True,
              norm_t=True, add_t=True, train_2d=True, down_factor=down_factor)
    got_dm = toformer.PlOformerSwpDatamodule(**kw)
    want_dm = joformer.PlOformerSwpDatamodule(**kw)
    assert got_dm.field_shape("test") == want_dm.field_shape("test")
    for split, seed in (("train", 1), ("test", None)):
        assert got_dm.num_batches(split) == want_dm.num_batches(split)
        rng = lambda: None if seed is None else np.random.default_rng(seed)
        got = list(got_dm.iter_split(split, rng()))
        want = list(want_dm.iter_split(split, rng()))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert_resized_close(a, b)


def test_missing_store_raises_at_read(tmp_path):
    with pytest.raises((FileNotFoundError, OSError)):
        th5.read_store(os.path.join(str(tmp_path), "absent.h5"))
