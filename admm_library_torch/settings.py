"""Solver settings: the same fields, defaults and validation as the JAX
package's `Settings`, so `Settings(**dataclasses.asdict(other))` carries
a configuration across unchanged.

A frozen, hashable dataclass. `check_every` is the number of fused ADMM
iterations between two residual checks; each check is one small
device-to-host read in this package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Settings:
    # --- ADMM penalty / splitting parameters (OSQP defaults) ---
    rho: float = 0.1            # initial penalty rho-bar
    rho_eq_scale: float = 1e3   # rho boost on equality rows (l == u)
    # Penalty scale for consensus agreement rows of the horizon-
    # partitioned solvers; -1 follows rho_eq_scale.
    rho_edge_scale: float = -1.0
    # rho boost on SOC rows (uniform across each block so the cone
    # projection stays the exact prox); 1.0 = no boost.
    rho_soc_scale: float = 1.0
    sigma: float = 1e-6         # x-update regularisation
    alpha: float = 1.6          # over-relaxation in (0, 2)

    # --- termination ---
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    eps_pinf: float = 1e-5      # primal infeasibility tolerance
    eps_dinf: float = 1e-5      # dual infeasibility tolerance
    max_iter: int = 20000
    check_every: int = 25       # residual/termination cadence

    # --- adaptive rho ---
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 100   # in iterations; multiple of check_every
    adaptive_rho_tol: float = 5.0      # update only if ratio drifts this much
    rho_min: float = 1e-6
    rho_max: float = 1e6

    # --- restarted iterate averaging (PDLP-style); 0 disables ---
    restart_every: int = 200
    # Stall exit: Status.STALLED once the best scaled residual ratio has
    # not improved for this many consecutive checks (0 disables).
    stall_checks: int = 16

    # --- Ruiz equilibration; 0 disables ---
    scaling_iters: int = 10

    # --- precision strategy ---
    # 'hybrid': f32 phase to `hybrid_eps`, then f32 re-centred rounds,
    #   then a capped, warm-started f64 phase only where still needed.
    # 'single': solve in the problem's own dtype. 'double': cast to f64.
    precision: str = "hybrid"
    hybrid_eps: float = 1e-4
    recenter_rounds: int = 2
    recenter_max_iter: int = 2000

    # --- linear system backend ---
    # 'auto' | 'chol' | 'inv' | 'banded' | 'cg' | 'pallas_cg' | 'spike'
    # ('banded' and 'spike' need band_block; 'spike' also spike_parts).
    # cg_tol / cg_max_iter drive both CG backends.
    backend: str = "auto"
    spike_parts: int = 0
    cg_tol: float = 1e-9
    cg_max_iter: int = 200
    refine_steps: int = 1       # iterative-refinement steps on the KKT solve

    # Block-tridiagonal block size; 0 means "not banded".
    band_block: int = 0

    # --- fused iteration kernel (shared-matrix batch path) ---
    # 'auto' / 'on': the hand-written CUDA kernel on f32 'inv' batches
    # (its plain twin for CPU tensors); 'off': the plain iteration body.
    fused: str = "auto"

    # --- misc ---
    warm_start: bool = True
    polish: bool = True
    polish_refine_steps: int = 3
    history: int = 0            # residual ring-buffer slots (0 disables)

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.backend not in (
                "auto", "chol", "inv", "banded", "cg", "pallas_cg",
                "spike"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "spike" and self.spike_parts <= 0:
            raise ValueError("backend 'spike' requires spike_parts > 0")
        if self.precision not in ("hybrid", "single", "double"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.fused not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused mode {self.fused!r}")
