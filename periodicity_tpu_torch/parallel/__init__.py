"""Multi-device parallelism (mesh, sharded scans, collectives).

Port of ``periodicity_tpu/parallel``. The reference's only parallelism is
multiprocessing.Pool over trial periods and ensemble members (reference
phase.py:69-70,183-186; decomposition.py:277,304). Here one process a
device joins a ``torch.distributed`` process group, and a named
``DeviceMesh`` lays the work over the ranks:

- trial-frequency/period **grid sharding**: each rank scores its slice of
  the grid with the single-device scan; the result is a DTensor sharded
  over the grid axis;
- **batch sharding**: the batch axis of many light curves laid over ranks;
- **ensemble sharding**: MCMC walkers as a sharded axis
  (``models.gp.mcmc.run_ensemble_sharded``);
- **sequence sharding**: a radix-D distributed FFT for long-series ACFs,
  and the time-sharded GP likelihood
  (``models.gp.pscan.log_likelihood_sharded``).

Single process stays the zero-config default: :func:`default_mesh` starts
a world of one when no group exists, exactly as the reference is
single-process by default.
"""

from .dfft import distributed_acf, distributed_fft, distributed_ifft
from .distributed import initialize_distributed, multihost_mesh
from .mesh import default_mesh, grid_sharding
from .sharded import (
    sharded_acf,
    sharded_aov,
    sharded_bls,
    sharded_conditional_entropy,
    sharded_gls,
    sharded_gregory_loredo,
    sharded_pdm,
    sharded_string_length,
)

__all__ = [
    "default_mesh",
    "grid_sharding",
    "sharded_gls",
    "sharded_pdm",
    "sharded_string_length",
    "sharded_bls",
    "sharded_aov",
    "sharded_conditional_entropy",
    "sharded_gregory_loredo",
    "sharded_acf",
    "distributed_fft",
    "distributed_ifft",
    "distributed_acf",
    "initialize_distributed",
    "multihost_mesh",
]
