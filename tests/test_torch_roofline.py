"""The port's roofline accounting (``utils/roofline.py``) against the
JAX package's: the same carry passes, byte floors and ceilings; and its
own peak table, keyed on CUDA device names, that knows no TPU."""

import pytest

from cs87project_msolano2_tpu.utils import roofline as ref_roofline
from cs87project_msolano2_tpu_torch.utils import roofline

H100_SXM = "NVIDIA H100 80GB HBM3"


def test_carry_passes_match_reference():
    assert roofline.PLAN_CARRY_PASSES == ref_roofline.PLAN_CARRY_PASSES
    for variant in list(roofline.PLAN_CARRY_PASSES) + ["jnp", "stages"]:
        assert roofline.plan_carry_passes(variant) == \
            ref_roofline.plan_carry_passes(variant)


@pytest.mark.parametrize("n", [1 << 10, 1 << 22, 1 << 27])
@pytest.mark.parametrize("domain", ["c2c", "r2c"])
@pytest.mark.parametrize("passes", [0, 1, 2])
def test_byte_model_matches_reference(n, domain, passes):
    assert roofline.fft_min_hbm_bytes(n, domain) == \
        ref_roofline.fft_min_hbm_bytes(n, domain)
    assert roofline.fft_hbm_bytes(n, passes, domain) == \
        ref_roofline.fft_hbm_bytes(n, passes, domain)
    assert roofline.roofline_ceiling(passes) == \
        ref_roofline.roofline_ceiling(passes)


def test_ceilings_of_the_large_n_plans():
    ceil = roofline.roofline_ceiling
    assert ceil(roofline.plan_carry_passes("fourstep")) == 0.5
    assert ceil(roofline.plan_carry_passes("sixstep")) == pytest.approx(1 / 3)
    assert ceil(roofline.plan_carry_passes("stages")) is None


@pytest.mark.parametrize("name,bw", [
    (H100_SXM, 3.35e12), ("NVIDIA H100 SXM5 80GB", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12), ("NVIDIA H200", 4.8e12),
    ("TPU v5 lite", None), ("v5e", None), ("Tesla T4", None), ("", None)])
def test_peak_table_by_cuda_name(name, bw):
    assert roofline.peak_bytes_per_s(name) == bw


@pytest.mark.parametrize("k,ms", [(22, 0.0200), (24, 0.0801), (25, 0.1603),
                                  (27, 0.6410)])
def test_bound_of_the_large_n_paths(k, ms):
    # the 16 B/element floor over 3.35 TB/s: bytes, not operations, bound
    n = 1 << k
    got, by = roofline.bound_ms(roofline.fft_min_hbm_bytes(n),
                                5 * n * k, H100_SXM)
    assert by == "bytes" and round(got, 4) == ms


def test_bound_refuses_an_unknown_card():
    with pytest.raises(ValueError, match="no data-sheet peaks"):
        roofline.bound_ms(1 << 20, 0, "TPU v5e")
