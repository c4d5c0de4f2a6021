"""``models.fft.fft_planes_fast(xr, xi, natural=...)`` on float re and im
planes of the configuration's complex dtype; pi (bit-reversed) order out
with ``natural`` false."""

from benchlib import counts, inputs


def make_inputs(shape, count, seed, device, config):
    block = inputs.normal_block((2,) + tuple(shape), count, seed, device,
                                inputs.real_dtype(config["dtype"]))
    return [(block[i, 0], block[i, 1]) for i in range(count)]


def bind(precision, natural=True):
    fn = inputs.port("models.fft").fft_planes_fast

    def call(ins):
        return fn(ins[0], ins[1], natural=natural, precision=precision)
    return call


def flops(shape, natural=True):
    return counts.transform_flops(shape, "c2c")


def plan(shape, precision, device, natural=True):
    return inputs.static_plan(shape, "natural" if natural else "pi",
                              precision, "c2c", device)
