"""The port's card discovery, node labels and labeler against the
reference's (``tpu_cluster/discovery``) on equivalent fake device trees:
the same indices with the NVIDIA control nodes ignored, the same label
set through the stated key mapping (no-card deletion included), and the
labeler's records and condition across cycles, as
``tests/test_discovery.py`` drives the reference's Python labeler."""

import json
import os

import pytest

from tpu_cluster.discovery import devices as ref_devices
from tpu_cluster.discovery import labeler as ref_labeler
from tpu_cluster.discovery import labels as ref_labels
from tpu_cluster_torch.discovery import devices, labeler, labels

# the reference's key -> the port's (gpu-feature-discovery's names where
# it has a key of the same meaning)
KEY_MAP = {
    ref_labels.PRESENT: labels.PRESENT,
    ref_labels.TYPE: labels.PRODUCT,
    ref_labels.GENERATION: labels.FAMILY,
    ref_labels.TOPOLOGY: labels.TOPOLOGY,
    ref_labels.COUNT: labels.COUNT,
    ref_labels.ICI_DOMAIN: labels.NVLINK_DOMAIN,
}
# hosts of the same size: the reference's and the port's layout names
SAME_SIZE = [("v5e-8", "h100-sxm5-80gb-8", 8), ("v5e-1", "h100-sxm5-80gb-1", 1)]


def _trees(tmp_path, n):
    ref_root, root = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_devices.make_fake_tree(ref_root, n)
    devices.make_fake_tree(root, n)
    return ref_root, root


@pytest.mark.parametrize("n", [0, 1, 3, 8])
def test_discover_matches_reference_and_ignores_control_nodes(tmp_path, n):
    ref_root, root = _trees(tmp_path, n)
    want = ref_devices.discover("/dev/accel*", devfs_root=ref_root)
    names = set(os.listdir(os.path.join(root, "dev")))
    assert set(devices.CONTROL_NODES) | {devices.CAPS_DIR} <= names
    # the default glob and the broad one find the same cards: the control
    # nodes have no trailing digits, nvidia-caps/ holds its nodes a level down
    for glob in ("/dev/nvidia[0-9]*", "/dev/nvidia*"):
        got = devices.discover(glob, devfs_root=root)
        assert [d.index for d in got] == [d.index for d in want]
        assert [os.path.basename(d.path) for d in got] == \
            [os.path.basename(d.path).replace("accel", "nvidia")
             for d in want]
        assert not any(d.vfio for d in got)


def test_discover_vfio_matches_reference(tmp_path):
    ref_devices.make_fake_tree(str(tmp_path / "ref"), 4, vfio=True)
    devices.make_fake_tree(str(tmp_path / "port"), 4, vfio=True)
    want = ref_devices.discover_vfio(devfs_root=str(tmp_path / "ref"))
    got = devices.discover_vfio(devfs_root=str(tmp_path / "port"))
    assert [(d.index, d.vfio) for d in got] == \
        [(d.index, d.vfio) for d in want] == [(i, True) for i in range(4)]


@pytest.mark.parametrize("ref_acc,acc,n", SAME_SIZE)
def test_labels_match_reference_through_the_mapping(tmp_path, ref_acc, acc, n):
    ref_root, root = _trees(tmp_path, n)
    want = ref_labels.compute_labels(
        ref_acc, ref_devices.discover("/dev/accel*", devfs_root=ref_root),
        "node-1")
    got = labels.compute_labels(acc, devices.discover(devfs_root=root),
                                "node-1")
    assert set(got) == set(labels.ALL_KEYS) == set(KEY_MAP.values())
    mapped = {KEY_MAP[k]: v for k, v in want.items()}
    # equal where the meaning carries over unchanged
    for key in (labels.PRESENT, labels.COUNT, labels.NVLINK_DOMAIN):
        assert got[key] == mapped[key]
    # gpu-feature-discovery's value formats, and the port's own topology
    assert got[labels.PRODUCT] == "NVIDIA-H100-80GB-HBM3"
    assert got[labels.FAMILY] == "hopper"
    assert got[labels.TOPOLOGY] == f"1x{n}"
    assert labels.compute_labels(acc, devices.discover(devfs_root=root)
                                 )[labels.NVLINK_DOMAIN] == "local"


def test_no_cards_deletes_every_key_but_present_as_the_reference():
    want = ref_labels.compute_labels("v5e-8", [])
    got = labels.compute_labels("h100-sxm5-80gb-8", [])
    assert got == {KEY_MAP[k]: v for k, v in want.items()}
    assert got[labels.PRESENT] == "false"
    assert b'"nvidia.com/gpu.count": null' in labeler.node_patch(got)


def _records(path):
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("ref_acc,acc,n", SAME_SIZE)
def test_labeler_print_and_out_file_match_reference(tmp_path, capsys,
                                                    monkeypatch, ref_acc, acc,
                                                    n):
    monkeypatch.setenv("NODE_NAME", "node-7")
    ref_root, root = _trees(tmp_path, n)
    assert ref_labeler.main([f"--accelerator={ref_acc}", "--oneshot",
                             "--print", "--conditions",
                             f"--devfs-root={ref_root}"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert labeler.main([f"--accelerator={acc}", "--oneshot", "--print",
                         "--conditions", f"--devfs-root={root}"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"labels", "condition"}
    for key in (ref_labels.PRESENT, ref_labels.COUNT, ref_labels.ICI_DOMAIN):
        assert got["labels"][KEY_MAP[key]] == want["labels"][key]
    cond, ref_cond = got["condition"], want["condition"]
    assert (cond["type"], ref_cond["type"]) == ("GpuReady", "TpuReady")
    assert cond["status"] == ref_cond["status"] == "True"
    assert cond["reason"] == "AllGpusPresent"
    assert cond["message"] == f"{n}/{n} GPUs present"
    assert set(cond) == set(ref_cond)

    out = tmp_path / "records.jsonl"
    ref_out = tmp_path / "ref_records.jsonl"
    for mod, a, r, path in ((ref_labeler, ref_acc, ref_root, ref_out),
                            (labeler, acc, root, out)):
        assert mod.main([f"--accelerator={a}", "--oneshot",
                         f"--devfs-root={r}", f"--out-file={path}"]) == 0
    assert capsys.readouterr().out == ""
    [rec], [ref_rec] = _records(out), _records(ref_out)
    assert "condition" not in rec and "condition" not in ref_rec
    assert rec["labels"] == {KEY_MAP[k]: v for k, v in ref_rec["labels"].items()
                             if KEY_MAP[k] not in (labels.PRODUCT,
                                                   labels.FAMILY,
                                                   labels.TOPOLOGY)} | {
        labels.PRODUCT: "NVIDIA-H100-80GB-HBM3", labels.FAMILY: "hopper",
        labels.TOPOLOGY: f"1x{n}"}


@pytest.mark.parametrize("found", [8, 5, 0])
def test_condition_states_and_transition_time_match_reference(found):
    want = [ref_labeler.tpu_ready_condition("v5e-8", found, now="T1")]
    got = [labeler.gpu_ready_condition("h100-sxm5-80gb-8", found, now="T1")]
    # two more cycles: the same census, then a card lost or found
    for now, count in (("T2", found), ("T3", 8 if found != 8 else 5)):
        want.append(ref_labeler.tpu_ready_condition(
            "v5e-8", count, now=now, previous=want[-1]))
        got.append(labeler.gpu_ready_condition(
            "h100-sxm5-80gb-8", count, now=now, previous=got[-1]))
    reasons = {"AllChipsPresent": "AllGpusPresent",
               "DegradedChipSet": "DegradedGpuSet",
               "NoTpuDevices": "NoGpuDevices"}
    for g, w in zip(got, want):
        assert g["type"] == "GpuReady"
        assert (g["status"], g["reason"], g["lastHeartbeatTime"],
                g["lastTransitionTime"]) == \
            (w["status"], reasons[w["reason"]], w["lastHeartbeatTime"],
             w["lastTransitionTime"])
    assert got[1]["lastTransitionTime"] == "T1"   # held across a heartbeat
    assert got[2]["lastTransitionTime"] == "T3"   # moved on a flip
    body = json.loads(labeler.status_patch(got[0]))
    assert body == {"status": {"conditions": [got[0]]}}


def test_labeler_fatal_config_errors_as_reference(tmp_path, capsys,
                                                  monkeypatch):
    assert labeler.main(["--accelerator=b99", "--oneshot", "--print"]) == 2
    assert "unknown host type 'b99'" in capsys.readouterr().err
    monkeypatch.delenv("NODE_NAME", raising=False)
    assert labeler.main(["--oneshot"]) == 2
    assert "NODE_NAME" in capsys.readouterr().err


def test_labeler_fake_devices_as_reference(capsys):
    assert ref_labeler.main(["--accelerator=v5e-8", "--oneshot", "--print",
                             "--fake-devices=3"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert labeler.main(["--oneshot", "--print", "--fake-devices=3"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["labels"][labels.COUNT] == want["labels"][ref_labels.COUNT] \
        == "3"
