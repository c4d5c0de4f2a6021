"""Backends behind the reference's run contract: ``torch`` (the plain
funnel/tube) and ``cuda`` (the funnel, then the tube on the kernels)."""
