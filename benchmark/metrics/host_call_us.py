"""The mean host time of one call to the entry, until it returns: the
``bench.issue`` spans the harness keeps on the host clock in the traced
window."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.span_ns("bench.issue")
    return sum(spans) / len(spans) / 1e3 if spans else None
