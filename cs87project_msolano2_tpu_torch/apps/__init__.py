"""The spectral operation suite (the reference's ``apps/`` package).

* :mod:`.pde` — the spectral solver family: one spectral pipeline
  parameterized by its multiplier (Poisson, constant- and
  variable-coefficient Helmholtz, an exact spectral time-stepper),
  single-device and slab-sharded; ``parallel/poisson3d.py`` is a thin
  shim over it.

The reference's fused convolution/correlation executors
(``apps/spectral.py``), overlap-save/add (``apps/stream.py``) and the
``apps`` CLI come with a later slice.
"""
