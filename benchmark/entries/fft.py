"""``models.fft.fft(x)`` on one complex tensor of the configuration's
dtype, natural order out."""

import torch

from benchlib import counts, inputs


def make_inputs(shape, count, seed, device, config):
    block = inputs.normal_block(shape, count, seed, device,
                                getattr(torch, config["dtype"]))
    return [(block[i],) for i in range(count)]


def bind(precision):
    fft = inputs.port("models.fft").fft

    def call(ins):
        return (fft(ins[0], precision=precision),)
    return call


def flops(shape):
    return counts.transform_flops(shape, "c2c")


def plan(shape, precision, device):
    return inputs.static_plan(shape, "natural", precision, "c2c", device)
