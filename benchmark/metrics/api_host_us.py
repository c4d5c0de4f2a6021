"""The mean host time a call spends in the port's entry outside the plan
lookup and the plan's execution: the planes split, the complex pack and
the entry's own Python (``fft.call`` less ``plan.lookup`` and
``plan.execute``, the port's spans in the traced window)."""

from benchlib import program


def read(run):
    split = program.host_split(run)
    return split and split["api"]
