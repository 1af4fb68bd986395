"""The port's accelerator catalogue: card names resolve to their entry,
unknown cards to nothing, and the override spelling folds as the
reference's lookup does (its error names the caller's string); the host
layouts hold as many cards as the reference's hosts of the same size."""

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


@pytest.mark.parametrize("ref_name,name,cards,label", [
    ("v5e-8", "h100-sxm5-80gb-8", 8, "1x8"),
    ("v5e-1", "h100-sxm5-80gb-1", 1, "1x1"),
])
def test_host_entries_against_same_sized_reference_hosts(ref_name, name,
                                                         cards, label):
    from tpu_cluster import topology as ref

    want = ref.get(ref_name)
    host = topology.get_host(name)
    assert host.cards_per_host == want.chips_per_host == cards
    assert want.num_hosts == 1
    assert host.card is topology.H100_SXM5_80GB
    assert host.label_topology() == label
    assert host.card.product == "NVIDIA H100 80GB HBM3"
    # the card's own entry resolves from the name NVML reports
    assert topology.from_device_name(host.card.product) is host.card


def test_get_host_folds_spelling_and_keeps_the_registries_apart():
    assert topology.get_host(" H100-SXM5-80GB-8 ") is \
        topology.H100_SXM5_80GB_8
    with pytest.raises(KeyError, match="'h100-sxm5-80gb'"):
        topology.get_host("h100-sxm5-80gb")
    with pytest.raises(KeyError, match="'h100-sxm5-80gb-8'"):
        topology.get("h100-sxm5-80gb-8")
