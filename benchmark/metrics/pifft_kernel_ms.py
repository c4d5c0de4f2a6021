"""Device time per transform in the port's own ``csrc/`` kernels, named
in ``kernels.json``: profiler trace."""


def read(run):
    if run.trace is None or not run.trace.device or not run.transforms:
        return None
    return run.trace.port_ns / run.transforms / 1e6
