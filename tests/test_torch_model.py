"""The port's Model builder against the JAX package's, leaf by leaf.

Both build the SO100 transfer-cube scene (K = 16) in float64; every float
leaf agrees to 1e-12 relative (1e-15 absolute for entries that are zero on
one side), and every int leaf, static tuple and the pair table are equal.
The bridge (`convert.model_from_numpy`) must reproduce the JAX Model
exactly."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu_torch.models.builder import ASSETS_XML as PORT_XML
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.models.convert import model_from_numpy

RTOL = 1e-12
ATOL = 1e-15


@pytest.fixture(scope="module")
def models():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=16)
    assert mj.qpos0.dtype == jnp.float64   # tests/conftest.py enables x64
    mt, _ = build_model(PORT_XML, max_contacts=16, device="cpu",
                        dtype=torch.float64)
    return mj, mt


def _jax_leaves(mj):
    out = {}
    for f in dataclasses.fields(mj):
        v = getattr(mj, f.name)
        out[f.name] = np.asarray(v) if hasattr(v, "dtype") and hasattr(v, "shape") else v
    return out


def test_scene_path_is_the_jax_asset():
    assert Path(PORT_XML) == Path(ASSETS_XML).resolve()


@pytest.mark.parametrize("field_kind", ["float", "int", "static"])
def test_port_build_matches_jax(models, field_kind):
    mj, mt = models
    jl = _jax_leaves(mj)
    checked = 0
    for name, jv in jl.items():
        tv = getattr(mt, name)
        if isinstance(jv, np.ndarray):
            assert isinstance(tv, torch.Tensor), name
            tv = tv.numpy()
            assert tv.shape == jv.shape, name
            if np.issubdtype(jv.dtype, np.floating):
                if field_kind != "float":
                    continue
                assert tv.dtype == np.float64, name
                np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL, err_msg=name)
            else:
                if field_kind != "int":
                    continue
                np.testing.assert_array_equal(tv, jv, err_msg=name)
            checked += 1
        elif field_kind == "static":
            if name == "pairs":
                for pf in ("box_box", "hull_box", "hull_hull", "ccd"):
                    assert getattr(tv, pf) == getattr(jv, pf), pf
            elif isinstance(jv, float):
                np.testing.assert_allclose(tv, jv, rtol=RTOL, err_msg=name)
            else:
                assert tv == jv, name
            checked += 1
    assert checked > 0


def test_shapes_of_the_main_path(models):
    _, mt = models
    assert (mt.nq, mt.nv, mt.nu, mt.nbody, mt.ngeom) == (13, 12, 6, 13, 25)
    assert (len(mt.pairs.box_box), len(mt.pairs.hull_box),
            len(mt.pairs.hull_hull)) == (62, 100, 29)


def test_bridge_reproduces_jax_model(models):
    mj, _ = models
    mb = model_from_numpy(_jax_leaves(mj))
    for name, jv in _jax_leaves(mj).items():
        tv = getattr(mb, name)
        if isinstance(jv, np.ndarray):
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)
        elif name != "pairs":
            assert tv == jv, name
    mb32 = model_from_numpy(_jax_leaves(mj), dtype=torch.float32)
    assert mb32.qpos0.dtype == torch.float32
    assert mb32.exact_polyvid.dtype == torch.int32


def test_ccd_manifold_tables_match(models):
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=16, ccd_manifolds=True)
    mt, _ = build_model(PORT_XML, max_contacts=16, device="cpu",
                        dtype=torch.float64, ccd_manifolds=True)
    assert mt.pairs.ccd == mj.pairs.ccd
    assert mt.exact_nvert == mj.exact_nvert
    for name in ("exact_verts", "exact_polyn"):
        np.testing.assert_allclose(getattr(mt, name).numpy(),
                                   np.asarray(getattr(mj, name)), rtol=RTOL, atol=ATOL)
    for name in ("exact_polyvid", "exact_polynv"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      np.asarray(getattr(mj, name)))


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(PORT_XML, max_contacts=16)
