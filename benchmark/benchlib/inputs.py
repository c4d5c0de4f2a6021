"""Inputs drawn on the device from the seed, for the entries to share."""

from __future__ import annotations

import importlib

import torch


def normal_block(shape, count: int, seed: int, device, dtype):
    """`count` distinct standard normal tensors of `shape` and `dtype`,
    drawn by one generator on `device` in one call, as rows of one
    block."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((count,) + tuple(shape), dtype=dtype, generator=gen,
                       device=device)


def real_dtype(complex_dtype: str):
    """The real dtype of the complex `complex_dtype` ("complex64")."""
    return torch.empty(0, dtype=getattr(torch, complex_dtype)).real.dtype


#: the program under test
PORT = "cs87project_msolano2_tpu_torch"


def port(module: str = ""):
    """The port's package, or its `module`: imported when an entry binds
    or plans, never when a module of the benchmark is imported."""
    return importlib.import_module(PORT + ("." + module if module else ""))


def static_plan(shape, layout: str, precision: str, domain: str,
                device) -> str:
    """The plan the port resolves for float planes of `shape`: the same
    key as its entries', so the plan layer's memo returns the very plan
    that serves the calls."""
    plan = port("plans").plan_for(shape, layout=layout,
                                  precision=precision, domain=domain,
                                  device=device)
    return f"{plan.served_variant()} {plan.describe()}"
