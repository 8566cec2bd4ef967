"""Port parity: ops/prox of admm_library_torch against the JAX package.

Inputs come from numpy with a seed and go through both packages. f64
throughout (the suite runs JAX with x64): the operators are elementwise
or blockwise with identical formulas, so they agree to f64 rounding of
the SOC norm (rtol 1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu.ops import prox as jprox
from admm_library_tpu.problem import ConeSpec as JCone
from admm_library_torch.ops import prox as tprox
from admm_library_torch.problem import ConeSpec as TCone

RTOL = 1e-12

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=1e-14)


def test_project_box_inf_bounds():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((5, 40)) * 3
    l = rng.standard_normal(40) - 1.0
    u = l + rng.random(40) * 2
    l[::3] = -np.inf
    u[::4] = np.inf
    _close(tprox.project_box(_t(v), _t(l), _t(u)),
           jprox.project_box(v, l, u))


@pytest.mark.parametrize("boxed", [False, True])
def test_soft_threshold(boxed):
    rng = np.random.default_rng(1)
    v = rng.standard_normal((4, 30)) * 2
    v[0, :5] = 0.0
    th = rng.random(30)
    if boxed:
        l, u = -0.8 * np.ones(30), 0.6 * np.ones(30)
        l[:3] = -np.inf
        _close(tprox.soft_threshold_box(_t(v), _t(th), _t(l), _t(u)),
               jprox.soft_threshold_box(v, th, l, u))
    else:
        _close(tprox.soft_threshold(_t(v), _t(th)),
               jprox.soft_threshold(v, th))


def _soc_points(rng, nblk, d):
    """Blocks in the cone, in the polar cone, and in neither."""
    u = rng.standard_normal((nblk, d - 1))
    nu = np.linalg.norm(u, axis=-1)
    branch = np.arange(nblk) % 3
    t = np.where(branch == 0, nu + 0.5,            # inside
                 np.where(branch == 1, -nu - 0.5,  # polar
                          0.3 * nu))               # projected onto surface
    return t, u, branch


def test_project_soc_block_all_branches():
    rng = np.random.default_rng(2)
    t, u, branch = _soc_points(rng, 12, 5)
    tt, tu = tprox.project_soc_block(_t(t), _t(u))
    jt, ju = jprox.project_soc_block(t, u)
    _close(tt, jt)
    _close(tu, ju)
    assert set(branch) == {0, 1, 2}
    np.testing.assert_array_equal(tt.numpy()[branch == 1], 0.0)


@pytest.mark.parametrize("dims", [(4, 4, 4), (3, 5, 2, 4)])
def test_project_soc_rows(dims):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((6, sum(dims)))
    _close(tprox.project_soc_rows(_t(v), dims),
           jprox.project_soc_rows(v, dims))


@pytest.mark.parametrize("with_offset", [False, True])
def test_project_cone_mixed(with_offset):
    """box + bounded L1 + uniform SOC, optionally with the f64 shifted-
    prox offset applied to f32 points (the re-centred rounds' case)."""
    rng = np.random.default_rng(4)
    mb, ml, d, nb = 7, 5, 3, 4
    m = mb + ml + d * nb
    v = rng.standard_normal((3, m))
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb] = -0.5
    u[:mb] = 0.5
    u[2] = np.inf
    l[mb:mb + ml], u[mb:mb + ml] = -0.7, 0.7
    lam = rng.random(ml)
    jc = JCone(m_box=mb, m_l1=ml, soc_dims=(d,) * nb)
    tc = TCone(m_box=mb, m_l1=ml, soc_dims=(d,) * nb)
    if with_offset:
        off = rng.standard_normal((3, m)) * 10
        v32 = v.astype(np.float32)
        got = tprox.project_cone(_t(v32), _t(l.astype(np.float32)),
                                 _t(u.astype(np.float32)),
                                 _t(lam.astype(np.float32)), tc,
                                 offset=_t(off))
        ref = jprox.project_cone(
            jnp.asarray(v32), jnp.asarray(l, jnp.float32),
            jnp.asarray(u, jnp.float32), jnp.asarray(lam, jnp.float32),
            jc, offset=jnp.asarray(off))
        assert got.dtype == torch.float32
        # f32 outputs of an f64 computation: one f32 rounding apart.
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)
    else:
        _close(tprox.project_cone(_t(v), _t(l), _t(u), _t(lam), tc),
               jprox.project_cone(v, l, u, lam, jc))
