"""From the start of the process to the start of the window: imports,
the CUDA context, the kernel library (its build on a checkout's first
run), the input ring, the plan and the warm-up (host clock)."""


def read(run):
    return run.setup_s
