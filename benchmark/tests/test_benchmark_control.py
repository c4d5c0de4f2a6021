"""The comparison has to fail what it guards against.

The control is the program's own bf16 storage mode in place of the
configuration's float32; the faults break the timed path underneath a
whole run (the look for a card skipped, the CPU's plain versions at a
size a test run holds): a call that returns its input unchanged, half
of the batch left out, one answer altered where it is produced, and an
answer altered on one ring slot or one in-flight position alone.
"""

import pytest

from benchlib import cell, spec

WORKLOADS = [w["name"] for w in spec.load_json(spec.SPEC_PATH)["workloads"]]
SMALL = {"fft1d-2p24": (1 << 12,), "rows-4096x4096": (16, 256)}


def _run(workload, seed=2**31 + 5, **kwargs):
    c = spec.load_cell(workload)
    return cell.run_cell(c, seed, 0.2, False, device="cpu",
                         shape=SMALL[c.config["name"]], **kwargs)[0]


def _unchanged(call):
    def run(inputs):
        if len(inputs) == 2:
            return tuple(t.clone() for t in inputs)
        out = call(inputs)[0]
        # the input in the output's place (its leading bins for r2c)
        return (inputs[0][..., :out.shape[-1]].to(out.dtype),)
    return run


def _half_left_out(call):
    def run(inputs):
        outs = tuple(t.clone() for t in call(inputs))
        for t in outs:
            t[t.shape[0] // 2:] = 0   # the later rows, or points in 1-D
        return outs
    return run


def _one_altered(call):
    def run(inputs):
        outs = tuple(t.clone() for t in call(inputs))
        outs[0].reshape(-1)[7] += outs[0].abs().mean() * 2
        return outs
    return run


def _alter(outs):
    outs = tuple(t.clone() for t in outs)
    outs[0].reshape(-1)[3] += outs[0].abs().mean() * 2
    return outs


def _one_ring_slot(call):
    """Alters the answers to the third distinct input of the ring."""
    seen = {}

    def run(inputs):
        slot = seen.setdefault(id(inputs[0]), len(seen))
        outs = call(inputs)
        return _alter(outs) if slot == 2 else outs
    return run


def _one_in_flight_position(call):
    """Alters every fourth call's answer: one event slot of a stream
    with 4 in flight (one call in four of a stream with 1)."""
    count = [0]

    def run(inputs):
        count[0] += 1
        outs = call(inputs)
        return _alter(outs) if count[0] % 4 == 1 else outs
    return run


@pytest.mark.parametrize("seed", [3, 2**31 + 77, 2**33 + 1])
@pytest.mark.parametrize("fault", [_one_ring_slot, _one_in_flight_position],
                         ids=["one_ring_slot", "one_in_flight_position"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_on_one_slot_is_not_correct(workload, fault, seed):
    result = _run(workload, seed=seed, wrap=fault)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_bf16_control_is_not_correct(workload):
    result = _run(workload, precision="bf16")
    assert not result["correct"]
    # it fails by a wide margin, not by rounding at the limit
    rel = result["checks"]["rel_l2"]
    assert rel["value"] > 10 * rel["limit"]


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _one_altered],
                         ids=["unchanged", "half_left_out", "one_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, fault):
    result = _run(workload, wrap=fault)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_path_is_correct(workload):
    assert _run(workload)["correct"]


def test_seeds_give_different_inputs_and_the_same_work():
    a = _run(WORKLOADS[0], seed=1)
    b = _run(WORKLOADS[0], seed=2)
    assert a["correct"] and b["correct"]
    assert a["checks"]["rel_l2"]["value"] != b["checks"]["rel_l2"]["value"]
