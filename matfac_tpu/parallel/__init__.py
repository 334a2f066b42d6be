from matfac_tpu.parallel.mesh import make_mesh, shard_state
from matfac_tpu.parallel.dsgd import DSGDShardedSolver

__all__ = ["make_mesh", "shard_state", "DSGDShardedSolver"]
