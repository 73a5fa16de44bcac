"""Sharded solvers on ``torch.distributed`` (port of ``sigsvgd_tpu/parallel``):
SPMD processes, one a rank, every function run on every rank of a group."""
from .distributed import global_particle_mesh, init_distributed, make_global_particles  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .mpf import sharded_mpf_observe  # noqa: F401
from .svgd import distributed_median, sharded_pathsig_score, sharded_svgd_run  # noqa: F401
