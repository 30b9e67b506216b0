"""The chain probe's port (gym_so100_tpu_torch/scripts/probe_chain.py)
against the JAX probe devtools/probe_pallas.py, and the kernel's CUDA
source compiled for the host (tests/kernels_host.py) against its plain
version.

The probe's inputs (numpy seed 0: a normalised normal q, a normal v, M =
0.1 normal + I) make the chain diverge in some lanes: every lane is finite
after 10 iterations, about a third are inf or nan after 50.  The chain
amplifies rounding, so each check keeps its reference's order of
operations, and compares the non-finite components as sets (nan where
nan, the same infinities) besides the finite ones:

* `chain_plain` (float32, B = 1024, n = 50) against the probe's Pallas
  body `pallas_kernel` run in interpret mode through a `pl.pallas_call`
  built here.  XLA on the CPU contracts the crosses' a b - c d into a
  fused multiply-add (one rounding where chain_plain and the kernel round
  twice; no compile option turns that off), so after one iteration a
  quarter of the components part by an ulp, and the chain amplifies
  that.  Held: the non-finite components equal as sets, and on the finite
  lanes each lane's largest deviation over its largest |v| within
  PALLAS_MAX = 2e-2 (measured 6.5e-3) and its median over the lanes
  within PALLAS_MEDIAN = 3e-5 (measured 3.2e-6);
* `chain_body_fn` against the probe's `chain_scan` at n = 10: float32
  within 1e-5 of max |v| (measured 1.0e-6 of it; the einsums sum in
  another order than XLA's dots), float64 within 1e-12 of it (measured
  1.3e-15);
* the CUDA source built for the host, bit-equal to `chain_plain` at n = 0,
  10 and 50, at batches that leave 8 envs in the last block's last warp
  (1000), every block full (1024) and one env in the last block (1025); a
  source with the rotation's sum regrouped, one row of M r regrouped or M's
  update rounded in another order fails that check.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from kernels_host import _I, _P, _build, _call, _out_buffer, host_tmp  # noqa: F401 (fixture)

from gym_so100_tpu_torch.scripts import probe_chain as pc

PROBE = Path(__file__).resolve().parents[1] / "devtools" / "probe_pallas.py"
PALLAS_B = 1024     # one (8, 128) tile per grid step
F32_TOL = 1e-5      # chain_body_fn vs chain_scan at n = 10, of max |v|
F64_TOL = 1e-12
PALLAS_MAX = 2e-2       # chain_plain vs pallas_kernel at n = 50, per lane of max |v|
PALLAS_MEDIAN = 3e-5    # ... the median over the finite lanes


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("probe_pallas", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B=PALLAS_B, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in pc.probe_inputs(B))


def _pallas_interpret(probe, q, v, M):
    """The probe's Pallas body over SoA numpy arrays, B a multiple of 1024."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    B = q.shape[1]
    tiles = B // probe.TILE
    blk = lambda x: jnp.asarray(x).reshape(x.shape[0], tiles, probe.SUB, probe.LANE)
    spec = lambda C: pl.BlockSpec((C, 1, probe.SUB, probe.LANE), lambda i: (0, i, 0, 0))
    out = pl.pallas_call(
        probe.pallas_kernel,
        out_shape=jax.ShapeDtypeStruct((3, tiles, probe.SUB, probe.LANE), jnp.float32),
        grid=(tiles,), in_specs=[spec(4), spec(3), spec(9)], out_specs=spec(3),
        interpret=True,
    )(blk(q), blk(v), blk(M))
    return torch.from_numpy(np.asarray(out).reshape(3, B).copy())


def _assert_equal(out, ref):
    c = pc.compare(out, ref)
    assert c["same_nonfinite"], c
    assert c["max_abs_err"] == 0.0, c
    return c


def test_probe_inputs_are_finite_at_10_and_diverge_by_50():
    q, v, M = _inputs(pc.B)
    assert q.shape == (4, pc.B) and v.shape == (3, pc.B) and M.shape == (9, pc.B)
    assert torch.allclose(q.double().norm(dim=0), torch.ones(pc.B, dtype=torch.float64),
                          atol=1e-6)
    assert bool(torch.isfinite(pc.chain_plain(q, v, M, 10)).all())
    c = pc.compare(pc.chain_plain(q, v, M, pc.N), pc.chain_plain(q, v, M, pc.N))
    assert 0 < c["nonfinite_lanes"] < pc.B, c


def test_chain_plain_matches_pallas_kernel_in_interpret_mode(probe):
    q, v, M = _inputs()
    ref = _pallas_interpret(probe, q.numpy(), v.numpy(), M.numpy())
    out = pc.chain_plain(q, v, M, pc.N)
    c = pc.compare(out, ref)
    assert c["same_nonfinite"], c
    assert 0 < c["nonfinite_lanes"] < PALLAS_B, c     # the check covers both kinds
    fin = torch.isfinite(ref).all(0)
    o, r = out[:, fin].double(), ref[:, fin].double()
    lane = (o - r).abs().amax(0) / r.abs().amax(0)
    assert float(lane.max()) <= PALLAS_MAX, float(lane.max())
    assert float(lane.median()) <= PALLAS_MEDIAN, float(lane.median())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_body_fn_matches_chain_scan(probe, dtype):
    import jax.numpy as jnp

    n = 10
    q, v, M = _inputs(dtype=dtype)
    B = q.shape[1]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = probe.chain_scan(jnp.asarray(q.T.numpy(), jdt), jnp.asarray(v.T.numpy(), jdt),
                           jnp.asarray(M.T.numpy().reshape(B, 3, 3), jdt), n)
    ref = torch.from_numpy(np.asarray(ref).T.copy())
    assert ref.dtype == dtype and bool(torch.isfinite(ref).all())
    out = pc.chain_body_fn(q, v, M, n)
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    assert err <= (F32_TOL if dtype == torch.float32 else F64_TOL) * scale, (err, scale)


def _host_chain(lib, q, v, M, n):
    out, tail = _out_buffer((3, q.shape[1]), torch.float32)
    _call(lib.gst_chain_probe, q, v, M, out, n, q.shape[1])
    assert bool(torch.isnan(tail).all()), "the kernel wrote past its output"
    return out


def _chain_lib(tmp, **kw):
    lib = _build(tmp, "chain_probe", "float", **kw)
    lib.gst_chain_probe.argtypes = [_P] * 4 + [_I] * 2 + [_P]
    return lib


@pytest.fixture(scope="module")
def host_chain_lib(host_tmp):
    return _chain_lib(host_tmp)


@pytest.mark.parametrize("n,B", [(n, B) for n in (0, 10, 50) for B in (1000, 1024, 1025)])
def test_host_kernel_source_equals_chain_plain(host_chain_lib, n, B):
    q, v, M = _inputs(B)
    ref = pc.chain_plain(q, v, M, n)
    c = _assert_equal(_host_chain(host_chain_lib, q, v, M, n), ref)
    assert (c["nonfinite_lanes"] == 0) if n < pc.N else (c["nonfinite_lanes"] > 0), c
    if n == 0:
        assert torch.equal(ref, v)


def test_host_kernel_launch_shape_and_refusals(host_chain_lib):
    import ctypes

    shape = (ctypes.c_int * 3)()
    host_chain_lib.gst_chain_probe_shape(4096, shape)
    assert tuple(shape) == (128, 128, 0)    # one env per thread, 4 warps
    q, v, M = _inputs(256)
    out = torch.zeros(3, 256)
    ptrs = [t.data_ptr() for t in (q, v, M, out)]
    assert host_chain_lib.gst_chain_probe(*ptrs, -1, 256, None) != 0
    assert host_chain_lib.gst_chain_probe(*ptrs, 10, 0, None) == 0
    assert bool((out == 0).all())


MUTATIONS = {
    # the rotation's sum: v + (w t + ct) for (v + w t) + ct
    "rotation_sum": ("const float r0 = v0 + w * t0 + ct0;",
                     "const float r0 = v0 + (w * t0 + ct0);"),
    # one row of M r: M[1][0] r0 + (M[1][1] r1 + M[1][2] r2)
    "row_sum": ("const float s1 = m[3] * r0 + m[4] * r1 + m[5] * r2;",
                "const float s1 = m[3] * r0 + (m[4] * r1 + m[5] * r2);"),
    # M's update as 0.001 (s_i r_j) for (0.001 s_i) r_j
    "update_order": ("m[3 * i + j] = m[3 * i + j] * c999 + si * r[j];",
                     "m[3 * i + j] = m[3 * i + j] * c999 + c001 * (s[i] * r[j]);"),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_mutated_host_kernel_source_fails(host_tmp, mutation):
    """Each mutation must break the bit-equality with chain_plain."""
    lib = _chain_lib(host_tmp, tag=f"_mut_{mutation}", mutate=MUTATIONS[mutation])
    q, v, M = _inputs()
    for n in (10, pc.N):
        c = pc.compare(_host_chain(lib, q, v, M, n), pc.chain_plain(q, v, M, n))
        assert not c["same_nonfinite"] or c["max_abs_err"] > 0, (n, c)


def test_chain_fused_runs_the_plain_version_on_the_cpu():
    q, v, M = _inputs(256)
    pc.chain_fused.launches = 0
    assert torch.equal(pc.chain_fused(q, v, M, 10), pc.chain_plain(q, v, M, 10))
    assert pc.chain_fused.launches == 0


def test_main_runs_on_the_cpu(capsys):
    assert pc.main(argv=["--device", "cpu", "--rows", "abdp"]) == 0
    out = capsys.readouterr().out
    for row in ("(a)", "(b)", "(d)", "(p)", "per extra iteration", "speedup of (d) over (a)"):
        assert row in out, out
