"""The pi-FFT algorithm and the natural-order FFT APIs built on it."""
