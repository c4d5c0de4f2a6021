"""The spectral operation suite (the reference's ``apps/`` package):
users buy operations — filtering, correlation, PDE solves — not bare
transforms, and this package builds them on the plan layer:

* :mod:`.spectral` — fused spectral convolution / cross-correlation (one
  rfft of each operand, a pointwise half-spectrum multiply on the
  device, one irfft, composed from the planned executors so the
  intermediate never reaches the host) with a kernel-spectrum cache,
  plus the op executors and numpy oracles an op-tagged batch rides;
* :mod:`.stream` — overlap-save / overlap-add block convolution for
  signals longer than any transform: one cached plan pair per block, a
  raced block size, an eager API, a push/generator API and a journaled
  kill-safe variant;
* :mod:`.pde` — the spectral solver family: one spectral pipeline
  parameterized by its multiplier (Poisson, constant- and
  variable-coefficient Helmholtz, an exact spectral time-stepper),
  single-device and slab-sharded; ``parallel/poisson3d.py`` is a thin
  shim over it;
* :mod:`.cli` — ``python -m cs87project_msolano2_tpu_torch apps
  {conv,corr,solve} [--smoke]``.

Every op has a minimum-traffic model
(``utils.roofline.spectral_min_hbm_bytes``) charged on the roofline's
bytes meter (``pifft_hbm_bytes_total``, counting while observability
is armed), so the fused-op floor is held from the meter by ``apps
--smoke``, not asserted in prose.
"""

from __future__ import annotations

from .spectral import (  # noqa: F401
    OPS,
    fftconv,
    fftcorr,
    kernel_spectrum,
    numpy_oracle,
    op_executor,
    solve_spectral_1d,
)
from .stream import (  # noqa: F401
    OverlapSave,
    choose_block,
    overlap_add,
    overlap_save,
    overlap_save_journaled,
    overlap_save_stream,
)
