"""Port parity for the block-tridiagonal backend: ops/banded.py of
admm_library_torch against the JAX package's on the same seeded numpy
inputs, the 'banded' branch of ops/kkt, config 2's MPC through `solve`
on 'banded', and `resolve_backend` against the reference's.

Bars: f64 factors and solves within atol 1e-10 of JAX (both compute the
same recursions; measured ≤ 1e-14); an f32 solve within 1e-4 of the
f64 solution relative to its scale (a few ulps times the condition
number of the test matrix, ~1e2); through `solve`, the repo's parity
bar (same status, iterations within one check interval, x within
1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu import api as japi
from admm_library_tpu.models import double_integrator as jdi
from admm_library_tpu.ops import banded as jbanded
from admm_library_tpu.ops import kkt as jkkt
import admm_library_torch as T
from admm_library_torch.ops import banded, kkt
from admm_library_torch.problem import ConeSpec

ATOL = 1e-10
CHECK = 25
FIELDS = ("P", "q", "A", "l", "u", "lam")

torch.set_num_threads(1)


def _block_tridiag_dense(seed, N=8, b=6):
    """Random SPD block-tridiagonal matrix (tests/test_kkt.py's)."""
    rng = np.random.default_rng(seed)
    n = N * b
    M = np.zeros((n, n))
    for i in range(N):
        D = rng.standard_normal((b, b))
        M[i*b:(i+1)*b, i*b:(i+1)*b] = D @ D.T + (2.0 + b) * np.eye(b)
        if i < N - 1:
            B = rng.standard_normal((b, b)) * 0.3
            M[(i+1)*b:(i+2)*b, i*b:(i+1)*b] = B
            M[i*b:(i+1)*b, (i+1)*b:(i+2)*b] = B.T
    return M


def _mpc_like_system(seed=10, N=6, b=4):
    """test_kkt.py's banded-through-kkt system: P block diagonal, A with
    one-step couplings, so M is block tridiagonal."""
    rng = np.random.default_rng(seed)
    n = N * b
    P = np.zeros((n, n))
    for i in range(N):
        D = rng.standard_normal((b, b))
        P[i*b:(i+1)*b, i*b:(i+1)*b] = D @ D.T + np.eye(b)
    A = np.zeros((N * b, n))
    for i in range(N):
        A[i*b:(i+1)*b, i*b:(i+1)*b] = np.eye(b)
        if i > 0:
            A[i*b:(i+1)*b, (i-1)*b:i*b] = rng.standard_normal((b, b)) * 0.2
    rho = np.abs(rng.standard_normal(N * b)) + 0.5
    return P, A, rho, rng.standard_normal(n), b


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=0.0)


def test_dense_to_block_tridiag_matches_jax():
    M = _block_tridiag_dense(5)
    jd, jl = jbanded.dense_to_block_tridiag(jnp.asarray(M), 6)
    td, tl = banded.dense_to_block_tridiag(_t(M), 6)
    assert td.shape == (8, 6, 6) and tl.shape == (7, 6, 6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    with pytest.raises(ValueError, match="not divisible"):
        banded.dense_to_block_tridiag(_t(M), 5)


def test_block_tridiag_cholesky_matches_jax():
    M = _block_tridiag_dense(6)
    jLd, jLl = jbanded.block_tridiag_cholesky(
        *jbanded.dense_to_block_tridiag(jnp.asarray(M), 6))
    tLd, tLl = banded.block_tridiag_cholesky(
        *banded.dense_to_block_tridiag(_t(M), 6))
    _close(tLd, jLd)
    _close(tLl, jLl)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_block_tridiag_solve_matches_jax(lead):
    """rhs with any leading dims against one unbatched factor (the
    reference folds them into the columns of each block solve)."""
    M = _block_tridiag_dense(8)
    rhs = np.random.default_rng(9).standard_normal(lead + (48,))
    jLd, jLl = jbanded.block_tridiag_cholesky(
        *jbanded.dense_to_block_tridiag(jnp.asarray(M), 6))
    tLd, tLl = banded.block_tridiag_cholesky(
        *banded.dense_to_block_tridiag(_t(M), 6))
    ref = jbanded.block_tridiag_solve(jLd, jLl, jnp.asarray(rhs))
    got = banded.block_tridiag_solve(tLd, tLl, _t(rhs))
    assert got.shape == lead + (48,)
    _close(got, ref)
    # And the dense solve.
    x = np.linalg.solve(M, rhs.reshape(-1, 48).T).T.reshape(rhs.shape)
    np.testing.assert_allclose(got.numpy(), x, atol=ATOL)


def test_block_tridiag_one_factor_per_lane_matches_jax():
    """M (B, n, n) with rhs (B, n): the shape `solve_batch` gives it; the
    reference reaches it under vmap."""
    Ms = np.stack([_block_tridiag_dense(s) for s in (11, 12, 13)])
    rhs = np.random.default_rng(14).standard_normal((3, 48))

    def jref(M, r):
        Ld, Ll = jbanded.block_tridiag_cholesky(
            *jbanded.dense_to_block_tridiag(M, 6))
        return Ld, Ll, jbanded.block_tridiag_solve(Ld, Ll, r)

    jLd, jLl, jx = jax.vmap(jref)(jnp.asarray(Ms), jnp.asarray(rhs))
    tLd, tLl = banded.block_tridiag_cholesky(
        *banded.dense_to_block_tridiag(_t(Ms), 6))
    assert tLd.shape == (3, 8, 6, 6) and tLl.shape == (3, 7, 6, 6)
    _close(tLd, jLd)
    _close(tLl, jLl)
    _close(banded.block_tridiag_solve(tLd, tLl, _t(rhs)), jx)
    with pytest.raises(ValueError, match="does not match"):
        banded.block_tridiag_solve(tLd, tLl, _t(rhs[:2]))


def test_block_tridiag_solve_f32():
    """One f32 case: within 1e-4 of the f64 solution, relative to its
    scale."""
    M = _block_tridiag_dense(6)
    rhs = np.random.default_rng(7).standard_normal((4, 48))
    Ld, Ll = banded.block_tridiag_cholesky(
        *banded.dense_to_block_tridiag(_t(M).float(), 6))
    got = banded.block_tridiag_solve(Ld, Ll, _t(rhs).float())
    assert got.dtype == torch.float32
    x = np.linalg.solve(M, rhs.T).T
    assert np.abs(got.double().numpy() - x).max() <= 1e-4 * np.abs(x).max()


def test_banded_backend_through_kkt_matches_jax():
    P, A, rho, rhs, b = _mpc_like_system()
    jfac = jkkt.factor_condensed(jnp.asarray(P), jnp.asarray(A), 1e-6,
                                 jnp.asarray(rho), "banded", band_block=b)
    tfac = kkt.factor_condensed(_t(P), _t(A), 1e-6, _t(rho), "banded",
                                band_block=b)
    for key in ("M", "Ld", "Ll"):
        _close(tfac[key], jfac[key])
    for refine in (0, 1):
        ref = jkkt.solve_condensed(jfac, jnp.asarray(rhs), "banded",
                                   refine_steps=refine)
        got = kkt.solve_condensed(tfac, _t(rhs), "banded",
                                  refine_steps=refine)
        _close(got, ref)
    M = kkt.condensed_matrix(_t(P), _t(A), 1e-6, _t(rho))
    assert float((M @ got - _t(rhs)).abs().max()) < 1e-9
    with pytest.raises(ValueError, match="band_block > 0"):
        kkt.factor_condensed(_t(P), _t(A), 1e-6, _t(rho), "banded")


def test_banded_not_positive_definite_gives_nan():
    """A block that is not positive definite poisons the factor with NaN
    (the NaN tripwire's input) instead of raising."""
    M = _block_tridiag_dense(6)
    M[18:24, 18:24] = -np.eye(6)
    Ld, Ll = banded.block_tridiag_cholesky(
        *banded.dense_to_block_tridiag(_t(M), 6))
    assert torch.isnan(Ld[3]).all()
    x = banded.block_tridiag_solve(Ld, Ll, torch.ones(48,
                                                      dtype=torch.float64))
    assert torch.isnan(x).any()


def _to_torch(qpj):
    c = qpj.cone
    return T.qp_from_numpy(
        {f: np.asarray(getattr(qpj, f)) for f in FIELDS},
        ConeSpec(m_box=c.m_box, m_l1=c.m_l1, soc_dims=tuple(c.soc_dims)),
        device="cpu")


@pytest.mark.parametrize("backend", ["banded", "auto"])
def test_small_mpc_on_banded_matches_jax(backend):
    """Config 2's rendezvous MPC at horizon 8 through `solve` on
    'banded' ('auto' with band_block resolves to it on the CPU in both
    packages)."""
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qpj, spec = jdi.build_mpc_qp(s0, np.zeros(6), N=8, dim=3)
    js = J.Settings(backend=backend, band_block=spec.block)
    ts = T.Settings(**dataclasses.asdict(js))
    assert T.resolve_backend(ts, "cpu", qpj.n) == "banded"
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj), ts)
    assert int(tsol.status) == int(jsol.status) == int(T.Status.SOLVED)
    assert abs(int(tsol.iters) - int(jsol.iters)) <= CHECK
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=1e-6)


_GRID = [(bb, be, n) for bb in (0, 9)
         for be in ("auto", "chol", "inv", "banded", "spike")
         for n in (None, 450, 4096)]


@pytest.mark.parametrize("band_block,backend,qp_n", _GRID)
def test_resolve_backend_matches_jax_off_the_card(band_block, backend,
                                                  qp_n):
    kw = dict(band_block=band_block, backend=backend,
              spike_parts=10 if backend == "spike" else 0)
    assert (T.resolve_backend(T.Settings(**kw), "cpu", qp_n)
            == japi.resolve_backend(J.Settings(**kw), qp_n))


def test_resolve_backend_on_cuda():
    """CUDA takes the TPU's branch: 'inv' up to n = 2048 with declared
    block structure, 'banded' above; an explicit backend is kept."""
    s = T.Settings(band_block=9)
    assert T.resolve_backend(s, "cuda", 450) == "inv"
    assert T.resolve_backend(s, "cuda", 2000) == "inv"
    assert T.resolve_backend(s, "cuda") == "inv"
    assert T.resolve_backend(s, "cuda", 4096) == "banded"
    assert T.resolve_backend(s, "cpu", 450) == "banded"
    assert T.resolve_backend(T.Settings(), "cuda", 4096) == "inv"
    assert T.resolve_backend(s.replace(backend="chol"), "cuda", 4096) == \
        "chol"
