"""Port parity for the fused ADMM iteration: the plain PyTorch twin
against the JAX Pallas kernel (interpret mode, as tests/test_fused.py
runs it), the CPU dispatch of the wrapper, and the port's import
boundary. The CUDA kernel itself is tested in test_torch_gpu.py.

The scaled problem and the factor are computed once by the JAX package
and carried across with numpy, so both sides iterate on identical f32
inputs; tolerances are those of tests/test_fused.py.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.core import admm as jadmm
from admm_library_tpu.core.scaling import ruiz_equilibrate
from admm_library_tpu.models import monte_carlo as jmc
from admm_library_tpu.ops import fused as jfused, kkt as jkkt
from admm_library_tpu.problem import ConeSpec as JCone, QPData as JQP
from admm_library_torch.ops import fused as tfused
from admm_library_torch.problem import ConeSpec as TCone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _operands(qp, settings, x, z, y):
    """JAX Ruiz + rho + 'inv' factor; returns the kernel's operands as
    numpy arrays, in the wrapper's argument order."""
    qps, _ = ruiz_equilibrate(qp, settings.scaling_iters)
    eq = jadmm.is_equality_row_shared(qps)
    rho = jadmm.rho_vec_of(jnp.asarray(settings.rho, qps.dtype), eq,
                           settings)
    fac = jkkt.factor_condensed(qps.P, qps.A, settings.sigma, rho, "inv")
    arrs = (qps.A, fac["Minv"], fac["M"], qps.q, rho, qps.lam, qps.l,
            qps.u, x, z, y)
    return qps.cone, [np.array(a, np.float32) for a in arrs]


def _box_case():
    settings = JSettings(precision="single", refine_steps=1)
    qp, _, _ = jmc.monte_carlo_mpc(jax.random.key(0), batch=4, N=6, dim=2,
                                   dtype=jnp.float32)
    B = 4
    zero = lambda w: jnp.zeros((B, w), jnp.float32)  # noqa: E731
    cone, ops = _operands(qp, settings, zero(qp.n), zero(qp.m), zero(qp.m))
    return settings, cone, ops, 10, (1e-5, 1e-6)


def _l1_soc_case():
    """Mixed cone: box + bounded L1 + uniform SOC blocks."""
    rng = np.random.default_rng(3)
    n, mb, ml, nsoc, d = 20, 8, 6, 3, 4
    m = mb + ml + nsoc * d
    cone = JCone(m_box=mb, m_l1=ml, soc_dims=(d,) * nsoc)
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(n), jnp.float32)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = jnp.asarray(R @ R.T + 0.5 * np.eye(n), jnp.float32)
    q = jnp.asarray(rng.standard_normal(n), jnp.float32)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -1.0, 1.0
    l[mb:mb + ml], u[mb:mb + ml] = -0.7, 0.7
    qp = JQP(P=P, q=q, A=A, l=jnp.asarray(l, jnp.float32),
             u=jnp.asarray(u, jnp.float32),
             lam=jnp.full((ml,), 0.3, jnp.float32), cone=cone)
    settings = JSettings(precision="single", refine_steps=1)
    B = 3
    x = jax.random.normal(jax.random.key(1), (B, n), jnp.float32)
    z = jnp.zeros((B, m), jnp.float32)
    _, ops = _operands(qp, settings, x, z, jnp.zeros((B, m), jnp.float32))
    return settings, cone, ops, 7, (1e-4, 1e-5)


def _tcone(c):
    return TCone(m_box=c.m_box, m_l1=c.m_l1, soc_dims=c.soc_dims)


def _kw(settings, cone, k):
    return dict(cone=cone, sigma=settings.sigma, alpha=settings.alpha, k=k,
                refine_steps=settings.refine_steps)


@pytest.mark.parametrize("case", [_box_case, _l1_soc_case],
                         ids=["box", "l1_soc"])
def test_twin_matches_pallas_interpret(case):
    settings, cone, ops, k, (rtol, atol) = case()
    ref = jfused.fused_iterate_shared(
        *map(jnp.asarray, ops), **_kw(settings, cone, k), interpret=True)
    got = tfused.fused_iterate_shared_reference(
        *map(torch.from_numpy, ops), **_kw(settings, _tcone(cone), k))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("case", [_box_case, _l1_soc_case],
                         ids=["box", "l1_soc"])
def test_wrapper_on_cpu_is_the_twin(case):
    settings, cone, ops, k, _ = case()
    kw = _kw(settings, _tcone(cone), k)
    before = tfused.fused_iterate_shared.launches
    got = tfused.fused_iterate_shared(*map(torch.from_numpy, ops), **kw)
    ref = tfused.fused_iterate_shared_reference(
        *map(torch.from_numpy, ops), **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert tfused.fused_iterate_shared.launches == before


def test_wrapper_rejects_ragged_soc():
    settings, cone, ops, k, _ = _l1_soc_case()
    ragged = TCone(m_box=cone.m_box, m_l1=cone.m_l1, soc_dims=(3, 4, 5))
    with pytest.raises(ValueError, match="uniform SOC"):
        tfused.fused_iterate_shared(*map(torch.from_numpy, ops),
                                    **_kw(settings, ragged, k))


def test_import_leaves_jax_out():
    code = ("import sys, admm_library_torch, admm_library_torch.ops.fused, "
            "admm_library_torch.parallel.batch, "
            "admm_library_torch.models.monte_carlo, "
            "admm_library_torch.utils.oracle; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'admm_library_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
