"""The port's minimal accelerator catalogue: card names resolve to their
entry, unknown cards to nothing, and the override spelling folds as the
reference's lookup does (its error names the caller's string)."""

import pytest

from tpu_cluster_torch import topology


@pytest.mark.parametrize("name,entry", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm5-80gb"),
    ("NVIDIA H100 SXM5 80GB", "h100-sxm5-80gb"),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
])
def test_from_device_name(name, entry):
    acc = topology.from_device_name(name)
    assert (acc.name if acc else None) == entry


def test_h100_entry_holds_data_sheet_ceilings():
    acc = topology.get("h100-sxm5-80gb")
    assert (acc.hbm_gib_per_chip, acc.peak_bf16_tflops, acc.hbm_bytes_per_s,
            acc.link_gbytes_per_s) == (80, 989.0, 3.35e12, 900.0)


def test_get_folds_spelling_and_names_the_callers_string():
    assert topology.get(" H100-SXM5-80GB ") is topology.H100_SXM5_80GB
    assert topology.canonical_name("v5litepod-4") == "v5litepod-4"
    with pytest.raises(KeyError, match="'B200-X'"):
        topology.get("B200-X")
