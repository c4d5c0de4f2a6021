"""Device time per transform in kernels, copies and sets that are not
the port's own ``csrc/`` kernels (the gather, the planes split and
pack, the domain passes): profiler trace."""


def read(run):
    if run.trace is None or not run.trace.device or not run.transforms:
        return None
    return run.trace.other_ns / run.transforms / 1e6
