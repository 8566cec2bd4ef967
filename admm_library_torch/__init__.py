"""admm_library_torch: the tpu-admm ADMM (OSQP-style) solver for
astrodynamics QPs and SOCPs, ported to PyTorch and CUDA for an NVIDIA
H100.

It keeps the JAX package's module layout, public names and batch layout
(x (B, n), z and y (B, m)). Entry points: `solve` for one problem,
`solve_batch_shared` for a batch that shares (P, A), and `solve_batch`
for a batch of independent problems. Over a `torch.distributed` mesh
(`parallel/runtime.py`): `solve_batch_shared(..., mesh=)` splits the
lanes (`parallel.make_data_mesh`, `parallel.shard_batch`),
`parallel.solve_rowsharded{,_hybrid}` the rows of one large problem,
`parallel.consensus_solve{,_mc}` a horizon into consensus blocks and
`parallel.solve_horizon_sharded` a horizon into exact SPIKE parts.
`utils/` holds the checkpoint, profiling and oracle helpers. The fused ADMM
iteration (ops/fused.py) and the batched Jacobi-PCG solve of the
'pallas_cg' backend (ops/pallas_cg.py) are hand-written CUDA kernels
(csrc/), built with nvcc on first use; on CPU tensors their plain
PyTorch twins run instead. Importing the package
turns TF32 off (precision.py): the solver needs exact f32 products.
"""
from . import precision as _precision

_precision.exact_f32()

from .api import resolve_backend, solve, solve_batch  # noqa: E402
from .parallel.batch import (  # noqa: E402
    make_data_mesh, shard_batch, solve_batch_shared)
from .problem import (  # noqa: E402
    ConeSpec, QPData, make_qp, objective, qp_from_numpy)
from .settings import Settings  # noqa: E402
from .solution import Solution, Status  # noqa: E402

__all__ = [
    "resolve_backend", "solve", "solve_batch", "solve_batch_shared",
    "make_data_mesh", "shard_batch",
    "ConeSpec", "QPData", "make_qp", "objective", "qp_from_numpy",
    "Settings", "Solution", "Status",
]
