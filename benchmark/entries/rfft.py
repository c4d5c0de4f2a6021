"""``models.real.rfft(x)`` on one real tensor of the configuration's
complex dtype's real dtype: the n/2+1 leading bins out."""

from benchlib import counts, inputs


def make_inputs(shape, count, seed, device, config):
    block = inputs.normal_block(shape, count, seed, device,
                                inputs.real_dtype(config["dtype"]))
    return [(block[i],) for i in range(count)]


def bind(precision):
    rfft = inputs.port("models.real").rfft

    def call(ins):
        return (rfft(ins[0], precision=precision),)
    return call


def flops(shape):
    return counts.transform_flops(shape, "r2c")


def plan(shape, precision, device):
    return inputs.static_plan(shape, "natural", precision, "r2c", device)
