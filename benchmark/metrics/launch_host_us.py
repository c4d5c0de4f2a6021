"""The mean host time a call spends launching the port's kernels: the
library calls of ``ops/cuda_fft._launch`` (the port's ``kernel.launch``
spans in the traced window); 0.0 where the calls launch none."""

from benchlib import program


def read(run):
    split = program.host_split(run)
    return split and split["launch"]
