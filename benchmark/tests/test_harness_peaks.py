"""The copied peaks and K1 bound give the bounds the port's records quote."""

import pytest

from benchmark.peaks import PEAKS, k1_bound_ms, peaks_for


@pytest.mark.parametrize("M,H,ms,bound", [(32, 1024, 0.00380, "bytes"),
                                          (1536, 1024, 0.02011, "operations"),
                                          (32, 2048, 0.01133, "bytes"),
                                          (1536, 2048, 0.05977, "operations")])
def test_k1_bound_matches_the_records(M, H, ms, bound):
    got, what, route = k1_bound_ms(M, 1000, H, PEAKS["H100"], bf16=True)
    assert round(got, 5) == ms and what == bound and route == "bf16"


def test_card_names():
    assert peaks_for("NVIDIA H100 80GB HBM3")[0] == "H100"
    assert peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    with pytest.raises(RuntimeError):
        peaks_for("cpu")
