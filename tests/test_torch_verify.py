"""The port's acceptance and triage runbooks (``tpu_cluster_torch.verify``,
``tpu_cluster_torch.triage``) against the reference's, on canned
``kubectl`` output.

One canned cluster serves both: the reference's own test runner
(``tests/test_verify.py::CannedRunner``, healthy and broken), answered in
the reference's names. The port's runner maps the port's argv to the
reference's names (``gpu-`` -> ``tpu-``, ``nvidia.com/gpu`` ->
``google.com/tpu``, ``GpuReady`` -> ``TpuReady``, ``driverPrep`` ->
``libtpuPrep``) and the answer back, keeping the names both stacks
share (the field manager ``tpu-operator``, the ``tpu-stack.dev`` group,
the operator's Lease). Compared exactly: every check's ``ok``; its
``detail`` once the reference's is mapped the same way; the snapshot's
``fetches``; triage's sections. Where the port differs by design
(dcgm-exporter's scrape in ``metrics``, triage's admission fix, its
node-status scrape and hints) the port's own output is checked.
"""

import json
import os
import stat
import subprocess
import sys

import pytest

from test_verify import CannedRunner, node, pod, policy_cr
from tpu_cluster import spec as ref_specmod
from tpu_cluster import triage as ref_triage
from tpu_cluster import verify as ref_verify
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch import telemetry, triage, verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference -> port, in this order
NAMES = (("libtpuPrep", "driverPrep"), ("tpu-libtpu-prep", "gpu-driver-prep"),
         ("google.com/tpu", "nvidia.com/gpu"), ("TpuReady", "GpuReady"),
         ("AllChipsPresent", "AllGpusPresent"),
         ("DegradedChipSet", "DegradedGpuSet"), ("TPU nodes", "GPU nodes"),
         ("tpu-", "gpu-"))
# names both stacks share (the native operator's contract)
SHARED = ('"manager": "tpu-operator"', "tpuctl/tpu-operator", "tpu-stack",
          "lease -n tpu-system tpu-operator", "lease -n gpu-system "
          "tpu-operator")
# the CLI name and the one message the port words for its single-host
# layouts (reference detail -> port detail)
MESSAGES = (("optional on single-host specs; tpuctl render", "optional; "
             "render"), ("tpuctl render", "render"),
            ("tpuctl apply", "apply"))


def swap(text, pairs, reverse=False):
    keep = {f"\0{i}\0": s for i, s in enumerate(SHARED)}
    for mark, shared in keep.items():
        text = text.replace(shared, mark)
    for a, b in pairs:
        text = text.replace(b, a) if reverse else text.replace(a, b)
    for mark, shared in keep.items():
        text = text.replace(mark, shared)
    return text


def to_port(text):
    return swap(swap(text, MESSAGES), NAMES)


class PortView:
    """The canned cluster seen in the port's names."""

    def __init__(self, canned):
        self.canned = canned
        self.calls = []

    def __call__(self, argv):
        self.calls.append(list(argv))
        ref_argv = [swap(a, NAMES, reverse=True) for a in argv]
        rc, out = self.canned(ref_argv)
        return rc, swap(out, NAMES)


@pytest.fixture(scope="module")
def ref_spec():
    return ref_specmod.default_spec()


@pytest.fixture(scope="module")
def spec():
    return specmod.default_spec()


def test_layouts_agree_on_the_card_count(ref_spec, spec):
    # the canned cluster's census is 8 a node for both
    assert ref_spec.tpu.accelerator_type.chips_per_host \
        == spec.gpu.host_type.cards_per_host == 8


PARITY_CHECKS = [n for n in ref_verify.CHECKS if n != "metrics"]


def test_the_port_has_the_reference_checks():
    assert list(verify.CHECKS) == list(ref_verify.CHECKS)
    assert verify.KNOWN_FIELD_MANAGERS == ref_verify.KNOWN_FIELD_MANAGERS
    assert verify.OPERAND_PODS == tuple(to_port(n)
                                        for n in ref_verify.OPERAND_PODS)
    assert verify.VALIDATION_JOBS == tuple(
        to_port(n) for n in ref_verify.VALIDATION_JOBS)


@pytest.mark.parametrize("healthy", [True, False],
                         ids=["healthy", "broken"])
@pytest.mark.parametrize("check", PARITY_CHECKS)
def test_check_agrees_with_the_reference(check, healthy, ref_spec, spec):
    canned = CannedRunner(healthy=healthy)
    want = ref_verify.CHECKS[check](canned, ref_spec)
    got = verify.CHECKS[check](PortView(CannedRunner(healthy=healthy)), spec)
    assert (got.name, got.ok) == (want.name, want.ok)
    assert got.detail == to_port(want.detail)


@pytest.mark.parametrize("healthy", [True, False],
                         ids=["healthy", "broken"])
def test_run_checks_fetches_and_results_agree(healthy, ref_spec, spec):
    ref_snap = ref_verify.ClusterSnapshot(CannedRunner(healthy=healthy))
    want = ref_verify.run_checks(PARITY_CHECKS, ref_spec, ref_snap)
    port_snap = verify.ClusterSnapshot(PortView(CannedRunner(healthy)))
    got = verify.run_checks(PARITY_CHECKS, spec, port_snap)
    assert [(r.name, r.ok, r.detail) for r in got] == [
        (r.name, r.ok, to_port(r.detail)) for r in want]
    assert port_snap.fetches == ref_snap.fetches > 0
    assert port_snap.registry.render() == ref_snap.registry.render()


def test_conditions_and_labels_on_a_degraded_node(ref_spec, spec):
    canned = CannedRunner(healthy=True)
    canned.responses["get nodes -l google.com/tpu.present=true"] = {
        "items": [node("tpu-node-0"), node("tpu-node-1", tpu=5)]}
    port = PortView(canned)
    for name in ("labels", "conditions"):
        want = ref_verify.CHECKS[name](canned, ref_spec)
        got = verify.CHECKS[name](port, spec)
        assert (got.ok, got.detail) == (want.ok, to_port(want.detail))
    assert "gpu-node-1: DegradedGpuSet" in got.detail and not got.ok


def test_policy_and_ownership_paths(ref_spec, spec):
    for disabled, phase in (((), "Ready"), (("libtpuPrep",), "Ready"),
                            ((), "Degraded")):
        canned = CannedRunner(healthy=True)
        canned.responses["get crd tpustackpolicies.tpu-stack.dev"] = {
            "kind": "CustomResourceDefinition"}
        canned.responses["get tpustackpolicies.tpu-stack.dev default"] = \
            policy_cr(phase=phase, disabled=disabled)
        want = ref_verify.check_policy(canned, ref_spec)
        got = verify.check_policy(PortView(canned), spec)
        assert (got.ok, got.detail) == (want.ok, to_port(want.detail))
    assert "driverPrep" in got.detail or phase == "Degraded"
    assert verify.check_ownership(PortView(CannedRunner()), spec).ok


def test_device_query_reads_the_trailing_json_of_merged_logs(spec):
    canned = CannedRunner(healthy=True)
    canned.device_query_logs = (
        "/usr/lib/python3/dist-packages/torch/cuda/__init__.py:61: "
        "FutureWarning: pynvml is deprecated\n  import pynvml\n"
        + json.dumps({"mode": "device-query", "device_count": 8,
                      "ok": True}, indent=2) + "\n")
    res = verify.check_device_query(PortView(canned), spec)
    assert res.ok and "8/8 devices" in res.detail
    canned.device_query_logs = "no json at all\n"
    assert not verify.check_device_query(PortView(canned), spec).ok


def dcgm_scrape(cards, extra=""):
    lines = []
    for family in verify.DCGM_FB_FAMILIES:
        lines += [f"# HELP {family} Framebuffer memory (in MiB).",
                  f"# TYPE {family} gauge"]
        lines += [f'{family}{{gpu="{i}",UUID="GPU-{i:04d}",device='
                  f'"nvidia{i}",modelName="NVIDIA H100 80GB HBM3",'
                  f'Hostname="gpu-node-0"}} {i * 1024}'
                  for i in range(cards)]
    return "\n".join(lines) + "\n" + extra


@pytest.mark.parametrize("cards,ok", [(8, True), (7, False), (0, False)])
def test_metrics_reads_dcgm_exporters_framebuffer_counters(spec, cards, ok):
    seen = []

    def runner(argv):
        seen.append(argv)
        return 0, dcgm_scrape(cards)

    res = verify.check_metrics(runner, spec)
    assert res.ok is ok, res.detail
    assert seen == [["kubectl", "get", "--raw",
                     "/api/v1/namespaces/gpu-system/services/"
                     "gpu-metrics-exporter:9400/proxy/metrics"]]
    if not ok:
        assert f"DCGM_FI_DEV_FB_USED for {cards}/8 card(s)" in res.detail


def test_metrics_reports_workload_gauges_and_fails_closed(spec):
    text = dcgm_scrape(8, 'tpu_duty_cycle_percent{chip="0"} 42.0\n')
    res = verify.check_metrics(lambda argv: (0, text), spec)
    assert res.ok and "tpu_duty_cycle_percent" in res.detail
    res = verify.check_metrics(lambda argv: (1, ""), spec)
    assert not res.ok and "scrape failed" in res.detail
    # the reference's exporter families do not satisfy the port's check
    tpu_text = 'tpu_chips_total 8\ntpu_hbm_capacity_bytes{chip="0"} 1\n'
    assert not verify.check_metrics(lambda argv: (0, tpu_text), spec).ok


def test_operator_metrics_scrapes_the_port_operator(spec):
    canned = CannedRunner(healthy=True)
    port = PortView(canned)
    res = verify.check_operator_metrics(port, spec)
    assert res.ok
    assert ["kubectl", "get", "--raw", "/api/v1/namespaces/gpu-system/"
            "services/gpu-operator:9402/proxy/metrics"] in port.calls
    missing = telemetry.OPERATOR_METRIC_NAMES[3]
    canned.raw["tpu-operator:9402/proxy/metrics"] = "".join(
        f"{name} 1\n" for name in telemetry.OPERATOR_METRIC_NAMES
        if name != missing)
    res = verify.check_operator_metrics(port, spec)
    assert not res.ok and missing in res.detail


# ------------------------------------------------------------- triage


def sections(report):
    return {s.split("\n", 1)[0]: s.split("\n", 1)[1] for s in report.sections}


BY_DESIGN = ("=== UnexpectedAdmissionError", "=== node GPU-stack status",
             "=== node TPU-stack status", "=== hints")


def add_extras(canned):
    canned.responses["get lease -n tpu-system tpu-operator"] = {
        "spec": {"holderIdentity": "tpu-operator-7f9c-abcde",
                 "renewTime": "2026-01-01T00:00:00Z",
                 "leaseDurationSeconds": 30, "leaseTransitions": 2}}
    canned.responses["get crd tpustackpolicies.tpu-stack.dev"] = {
        "kind": "CustomResourceDefinition"}
    canned.responses["get tpustackpolicies.tpu-stack.dev default"] = \
        policy_cr(disabled=("metricsExporter",))
    bad = pod("trainer", phase="Failed")
    bad["status"]["reason"] = "UnexpectedAdmissionError"
    bad["status"]["message"] = "Allocate failed: 9 devices requested"
    canned.responses["get pods -n tpu-system"]["items"].append(bad)
    return canned


@pytest.mark.parametrize("healthy", [True, False],
                         ids=["healthy", "broken"])
def test_triage_agrees_with_the_reference(healthy, ref_spec, spec):
    want = sections(ref_triage.run_triage(
        ref_spec, add_extras(CannedRunner(healthy=healthy))))
    port = PortView(add_extras(CannedRunner(healthy=healthy)))
    got = sections(triage.run_triage(spec, port))
    mapped = {to_port(t): to_port(b) for t, b in want.items()}
    assert [t for t in got if not t.startswith(BY_DESIGN)] == [
        t for t in mapped if not t.startswith(BY_DESIGN)]
    for title, body in got.items():
        if not title.startswith(BY_DESIGN):
            assert body == mapped[title], title
    assert "=== operator leader election ===" in got
    assert "tpu-operator" in " ".join(
        a for call in port.calls for a in call if "lease" in call)
    assert "lease holder: gpu-operator-7f9c-abcde" in \
        got["=== operator leader election ==="]
    assert "metricsExporter" in got[
        "=== operands disabled by TpuStackPolicy ==="]


def test_triage_gpu_sections(spec):
    port = PortView(add_extras(CannedRunner(healthy=True)))
    got = sections(triage.run_triage(spec, port))
    adm = got["=== UnexpectedAdmissionError pods (unsatisfiable GPU "
              "request) ==="]
    assert "trainer: Allocate failed: 9 devices requested" in adm
    assert ("fix: request a whole nvidia.com/gpu count between 1 and 8 for "
            "h100-sxm5-80gb-8") in adm
    assert ["kubectl", "get", "--raw", "/api/v1/namespaces/gpu-system/"
            "services/gpu-node-status-exporter:9401/proxy/metrics"] \
        in port.calls
    assert "=== node GPU-stack status ===" in got
    assert "nvidia.com/gpu=8" in got[
        "=== allocatable per node (device-plugin registration) ==="]
    assert "GpuReady=True" in got[
        "=== GpuReady node conditions (feature discovery) ==="]
    hints = got["=== hints ==="]
    assert "/var/lib/kubelet/device-plugins/nvidia-gpu.sock" in hints
    assert "/dev/nvidia[0-9]*" in hints
    # a disabled node-status exporter is not scraped
    off = specmod.default_spec()
    off.gpu.operands["nodeStatusExporter"] = specmod.OperandSpec(
        enabled=False)
    port = PortView(CannedRunner(healthy=True))
    assert "=== node GPU-stack status ===" not in sections(
        triage.run_triage(off, port))


# ---------------------------------------------------------------- CLI


@pytest.fixture()
def fake_kubectl(tmp_path, monkeypatch):
    """A ``kubectl`` on PATH that answers from a JSON table (argv after
    ``kubectl`` joined by spaces -> stdout; anything else rc 1), so the
    CLI's real subprocess runner is what runs."""
    table = {}
    canned = PortView(CannedRunner(healthy=True))

    def answer(argv):
        rc, out = canned(argv)
        if rc == 0:
            table[" ".join(argv[1:])] = out

    script = tmp_path / "kubectl"
    script.write_text(
        f"#!{sys.executable}\n"
        "import json, sys\n"
        f"table = json.load(open({str(tmp_path / 'table.json')!r}))\n"
        "out = table.get(' '.join(sys.argv[1:]))\n"
        "if out is None:\n"
        "    sys.exit(1)\n"
        "sys.stdout.write(out)\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")

    def write(argvs):
        for argv in argvs:
            answer(argv)
        (tmp_path / "table.json").write_text(json.dumps(table))
    return write


def run_cli(*argv):
    return subprocess.run([sys.executable, "-m", "tpu_cluster_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=os.environ.copy())


def test_cli_verify_json_subset_and_exit_codes(fake_kubectl):
    ns = "gpu-system"
    fake_kubectl([
        ["kubectl", "get", "nodes", "-l", "nvidia.com/gpu.present=true",
         "-o", "json"],
        ["kubectl", "get", "nodes", "-o", "json"],
        ["kubectl", "get", "job", "-n", ns, "gpu-device-query", "-o",
         "json"],
        ["kubectl", "logs", "-n", ns, "job/gpu-device-query"]])
    proc = run_cli("verify", "--json", "--config",
                   "labels,conditions,allocatable,device-query")
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["ok"] is True
    assert [c["name"] for c in doc["checks"]] == [
        "labels", "conditions", "allocatable", "device-query"]
    assert doc["kubectl_calls"] == 4  # the node list is fetched once
    proc = run_cli("verify", "--config", "labels,psum")
    assert proc.returncode == 1
    assert "[PASS] labels" in proc.stdout and "[FAIL] psum" in proc.stdout
    assert "(snapshot: 2 kubectl invocation(s) served 2 check(s))" \
        in proc.stdout
    assert run_cli("verify", "--config", "warp-drive").returncode == 2
    assert run_cli("verify", "--config", ",").returncode == 2


def test_cli_triage_prints_the_report(fake_kubectl):
    fake_kubectl([["kubectl", "get", "pods", "-n", "gpu-system", "-o",
                   "json"],
                  ["kubectl", "get", "nodes", "-o", "json"]])
    proc = run_cli("triage")
    assert proc.returncode == 0, proc.stderr
    assert "=== pods in gpu-system ===" in proc.stdout
    assert "gpu-device-plugin-x7k2f  Running" in proc.stdout
    assert "nvidia.com/gpu=8" in proc.stdout
    assert "=== hints ===" in proc.stdout
