"""Multi-rank layer on ``torch.distributed`` (the reference's
``parallel/`` package): meshes, the zero-collective sharded pi-FFT, the
data-parallel batched FFT, the all_to_all 2-D FFT and 3-D Poisson
configs, and their self-healing entries (collective supervision, the
collective-free escape, fallback consensus).

The reference runs one controller over a device mesh (``shard_map``);
the port runs one process per mesh position (multi-process SPMD).  The
entry points take and return this rank's blocks, as the reference's
per-device bodies do; the resilient entries take the whole input on
every rank.  ``multihost.spawn_local`` launches a local job."""

from .mesh import how_many_devices, make_mesh, make_mesh2d  # noqa: F401
from .pi_shard import pi_fft_sharded, pi_fft_sharded_batched  # noqa: F401
from .batched import fft_batched_sharded  # noqa: F401
from .fft2d import fft2_sharded, fft2_sharded_resilient  # noqa: F401
from .poisson3d import (  # noqa: F401
    poisson_solve_sharded,
    poisson_solve_sharded_resilient,
)
from .batched import fft_batched_planes, rfft_batched_sharded  # noqa: F401
from .fft2d import fft2_sharded_planes  # noqa: F401
from .escape import (  # noqa: F401
    ShardedRunReport,
    clear_unhealthy,
    fft2_collective_free,
    fft2_collective_free_planes,
    poisson_solve_collective_free,
    report_unhealthy,
    run_with_escape,
)
from .multihost import agree_on_fallback, spawn_local  # noqa: F401
