"""The pi-FFT algorithm and the natural-order FFT APIs built on it.

``rfft`` and ``irfft`` are exported here, as the reference exports
them; ``fft`` and its kin are not, since the name would hide the
``models.fft`` module its callers import."""

from .real import irfft, rfft  # noqa: F401
