"""The mean host time a call spends resolving its plan (the port's
``plan.lookup`` spans, ``plans.plan_for``, in the traced window)."""

from benchlib import program


def read(run):
    split = program.host_split(run)
    return split and split["lookup"]
