"""The mean host time a call spends in the plan's execution outside the
kernel launches: its checks, tables and fault site, and the issue of
the gather and of the real passes (the port's ``plan.execute`` spans
less ``kernel.launch``, in the traced window)."""

from benchlib import program


def read(run):
    split = program.host_split(run)
    return split and split["execute"]
