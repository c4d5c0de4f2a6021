"""The port's kernel launches in the window (the wrappers' ``launches``
counters in ``ops/cuda_fft.py``) per transform."""


def read(run):
    return run.launches / run.transforms if run.transforms else None
