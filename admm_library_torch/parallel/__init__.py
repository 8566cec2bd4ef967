from . import (batch, consensus, consensus_mc, horizon,  # noqa: F401
               rowshard, runtime)
from .batch import (                                          # noqa: F401
    make_data_mesh, shard_batch, solve_batch_shared)
from .consensus import ConsensusSpec, consensus_solve         # noqa: F401
from .consensus_mc import consensus_solve_mc                  # noqa: F401
from .horizon import (                                        # noqa: F401
    partition_qp, solve_horizon_sharded)
from .rowshard import (                                       # noqa: F401
    solve_rowsharded, solve_rowsharded_hybrid)
