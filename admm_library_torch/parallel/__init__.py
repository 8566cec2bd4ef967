from . import batch, consensus, consensus_mc, runtime           # noqa: F401
from .batch import solve_batch_shared                         # noqa: F401
from .consensus import ConsensusSpec, consensus_solve         # noqa: F401
from .consensus_mc import consensus_solve_mc                  # noqa: F401
