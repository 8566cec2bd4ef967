"""Monte-Carlo scenario dispersions of the rendezvous MPC, the CW
min-fuel rendezvous and the low-thrust SOCP.

A dispersion perturbs the initial state s0, which enters only the
constraint bounds of every model here, so the batch shares (P, q, A): a
bound-batched QPData for parallel.batch.solve_batch_shared.

`reference_s0(batch)` returns the dispersions that the JAX package's
`monte_carlo_mpc(jax.random.PRNGKey(0), batch)` draws, stored in
mc_s0_seed0.npz (torch.Generator draws other numbers from the same
seed), so the port can solve the reference's own batch.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..problem import QPData
from . import model_device
from . import clohessy_wiltshire as cw
from . import double_integrator as di
from . import low_thrust as lt

_REFERENCE_S0 = Path(__file__).with_name("mc_s0_seed0.npz")


def disperse_s0(generator: torch.Generator, s0_nominal, sigma_pos: float,
                sigma_vel: float, batch: int,
                dtype: torch.dtype = torch.float32, device=None):
    """Gaussian initial-state dispersion: (batch, ns) states; the first
    half of the state is position (sigma_pos), the second velocity
    (sigma_vel). The noise is drawn on the generator's device."""
    device = model_device(device)
    s0 = torch.as_tensor(s0_nominal, dtype=dtype, device=device)
    ns = s0.shape[-1]
    d = ns // 2
    noise = torch.randn((batch, ns), generator=generator, dtype=dtype,
                        device=generator.device).to(device)
    scale = torch.cat([torch.full((d,), sigma_pos, dtype=dtype, device=device),
                       torch.full((ns - d,), sigma_vel, dtype=dtype,
                                  device=device)])
    return s0 + noise * scale


def _nominal(dim, dtype, device):
    return torch.cat([torch.ones(dim, dtype=dtype, device=device),
                      -0.5 * torch.ones(dim, dtype=dtype, device=device)])


def monte_carlo_mpc_from_s0(s0s, N: int = 50, dim: int = 3,
                            dtype: torch.dtype = torch.float32,
                            device=None):
    """Bound-batched rendezvous MPC for the given initial states
    s0s (B, 2*dim). Returns (QPData, MPCSpec, s0s)."""
    device = model_device(device)
    if not isinstance(s0s, torch.Tensor):
        s0s = torch.from_numpy(np.array(s0s))
    s0s = s0s.to(dtype=dtype, device=device)
    qp, spec = di.build_mpc_qp(
        _nominal(dim, dtype, device),
        torch.zeros(2 * dim, dtype=dtype), N=N, dim=dim, dtype=dtype,
        device=device)
    l, u = di.mpc_bounds_for_s0(qp, spec, s0s)
    return (QPData(P=qp.P, q=qp.q, A=qp.A, l=l, u=u, lam=qp.lam,
                   cone=qp.cone), spec, s0s)


def monte_carlo_mpc(generator: torch.Generator, batch: int = 1024,
                    N: int = 50, dim: int = 3, sigma_pos: float = 0.1,
                    sigma_vel: float = 0.01,
                    dtype: torch.dtype = torch.float32, device=None):
    """Dispersed double-integrator rendezvous MPC batch.

    Returns (bound-batched QPData, MPCSpec, s0 batch (B, 2*dim)).
    """
    device = model_device(device)
    s0s = disperse_s0(generator, _nominal(dim, dtype, device), sigma_pos,
                      sigma_vel, batch, dtype, device)
    return monte_carlo_mpc_from_s0(s0s, N=N, dim=dim, dtype=dtype,
                                   device=device)


def _dispersed(builder, bounds_for_s0, s0_nominal, generator, batch,
               sigma_pos, sigma_vel, dtype, device, **kw):
    """Bound-batched QPData of `builder` at the nominal s0, bounds for
    `batch` draws around it: (QPData, spec, s0 batch (B, 6))."""
    s0_nom = torch.tensor(s0_nominal, dtype=dtype, device=device)
    qp, spec = builder(s0_nom, dtype=dtype, device=device, **kw)
    s0s = disperse_s0(generator, s0_nom, sigma_pos, sigma_vel, batch,
                      dtype, device)
    l, u = bounds_for_s0(qp, spec, s0s)
    return (QPData(P=qp.P, q=qp.q, A=qp.A, l=l, u=u, lam=qp.lam,
                   cone=qp.cone), spec, s0s)


def monte_carlo_cw(generator: torch.Generator, batch: int = 1024,
                   N: int = 20, sigma_pos: float = 50.0,
                   sigma_vel: float = 0.05,
                   dtype: torch.dtype = torch.float32, device=None):
    """Dispersed CW impulsive min-fuel rendezvous batch around a 1 km
    along-track offset with small radial and velocity errors.

    Returns (bound-batched QPData, CWSpec, s0 batch (B, 6)).
    """
    device = model_device(device)
    return _dispersed(cw.build_cw_rendezvous, cw.cw_bounds_for_s0,
                      [100.0, -1000.0, 20.0, 0.1, 0.5, -0.05], generator,
                      batch, sigma_pos, sigma_vel, dtype, device, N=N)


def monte_carlo_low_thrust(generator: torch.Generator, batch: int = 128,
                           N: int = 200, sigma_pos: float = 50.0,
                           sigma_vel: float = 0.05,
                           dtype: torch.dtype = torch.float32,
                           device=None):
    """Dispersed low-thrust SOCP batch.

    Returns (bound-batched QPData, LowThrustSpec, s0 batch (B, 6)).
    """
    device = model_device(device)
    return _dispersed(lt.build_low_thrust_socp, lt.lt_bounds_for_s0,
                      [500.0, -2000.0, 100.0, 0.0, 1.0, -0.1], generator,
                      batch, sigma_pos, sigma_vel, dtype, device, N=N)


def reference_s0(batch: int) -> np.ndarray:
    """The JAX reference's config-5 dispersions, (batch, 6) f32, for
    batch 128 or 1024 (N=50, dim=3, PRNGKey(0))."""
    with np.load(_REFERENCE_S0) as f:
        key = f"s0_batch{batch}"
        if key not in f:
            raise KeyError(f"no reference dispersions for batch {batch}")
        return f[key]
