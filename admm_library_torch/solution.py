"""Solution and status types."""
from __future__ import annotations

import dataclasses
import enum

import torch


class Status(enum.IntEnum):
    """Solver status codes (the JAX package's codes, unchanged)."""

    UNSOLVED = 0
    SOLVED = 1
    MAX_ITER = 2
    PRIMAL_INFEASIBLE = 3
    DUAL_INFEASIBLE = 4
    NUMERICAL_ERROR = 5
    # The scaled residual ratio stopped improving for
    # Settings.stall_checks consecutive checks; staged hybrid solvers
    # treat it like MAX_ITER and re-centre.
    STALLED = 6


@dataclasses.dataclass(frozen=True)
class Solution:
    """Solver result. Every tensor may carry a leading lane dimension.

    history is a (history_slots, 3) tensor of (iteration, r_prim,
    r_dual) snapshots; unused slots hold -1 in the iteration column.
    """

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    status: torch.Tensor      # int32, values from Status
    iters: torch.Tensor       # int32
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    obj: torch.Tensor
    rho: torch.Tensor
    history: torch.Tensor

    def leaves(self) -> dict:
        """The fields by name: the state a captured segment takes."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @property
    def solved(self):
        return self.status == int(Status.SOLVED)

    def status_name(self) -> str:
        if self.status.dim() != 0:
            return "<batched>"
        return Status(int(self.status)).name
