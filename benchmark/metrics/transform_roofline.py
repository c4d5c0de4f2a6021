"""The least time of one transform (each input byte read once, each
output byte written once, at the data-sheet bandwidth) as a share of
the device-busy time per transform in the traced window."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not run.peak_bytes_per_s \
            or not run.transforms:
        return None
    least_s = run.least_bytes_per_transform / run.peak_bytes_per_s
    busy_s = tr.busy_ns / 1e9 / run.transforms
    return 100.0 * least_s / busy_s
