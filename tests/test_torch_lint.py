"""The port's bundle linter (``tpu_cluster_torch/lint.py``) against the
reference's (``tpu_cluster/lint.py``).

- Every rule R01-R07 has a bundle that must fail and one that must pass.
- On the same bundle, mapped from ``google.com/tpu`` to
  ``nvidia.com/gpu``, the two packages give the same rule IDs,
  severities, objects and JSON paths wherever the rule is shared; the
  two deviations (R05's range where the reference has aligned sizes,
  R07 without slice tiling) are held as such.
- The self-audit: everything the port renders lints clean in strict
  mode, over every operand switch combination and both host layouts.
- The CLI's exit codes, the gate's modes, the tier tables against the
  reference's apply engine, and a render + lint with PyYAML blocked.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from tpu_cluster import kubeapply as ref_kubeapply
from tpu_cluster import lint as ref_lint
from tpu_cluster import spec as ref_specmod
from tpu_cluster.render import operator_bundle as ref_bundle
from tpu_cluster_torch import __main__ as cli
from tpu_cluster_torch import kubeapply, lint
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import jobs, manifests, operator_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "gpu-system"
GPU = "nvidia.com/gpu"


# ---------------------------------------------------------------------------
# fixture builders: minimal VALID objects a test then breaks in one way


def mk_namespace(name=NS):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name}}


def mk_workload(kind="DaemonSet", name="work", ns=NS, image="img:1",
                labels=None, template_labels=None, pod=None):
    labels = dict(labels or {"app": name})
    api = {"DaemonSet": "apps/v1", "Deployment": "apps/v1",
           "StatefulSet": "apps/v1", "Job": "batch/v1"}[kind]
    pod_spec = {"containers": [{"name": "c", "image": image}]}
    pod_spec.update(pod or {})
    obj = {"apiVersion": api, "kind": kind,
           "metadata": {"name": name, "namespace": ns},
           "spec": {"selector": {"matchLabels": labels},
                    "template": {
                        "metadata": {"labels": dict(template_labels
                                                    if template_labels
                                                    is not None else labels)},
                        "spec": pod_spec}}}
    if kind == "Job":  # Job selectors are controller-generated
        del obj["spec"]["selector"]
    return obj


def mk_configmap(name, ns=NS):
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": ns}, "data": {}}


def mk_sa(name, ns=NS):
    return {"apiVersion": "v1", "kind": "ServiceAccount",
            "metadata": {"name": name, "namespace": ns}}


def mk_service(selector, name="svc"):
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": name, "namespace": NS},
            "spec": {"selector": selector, "ports": [{"port": 80}]}}


def mk_binding(role="r", sa="s"):
    return {"apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding", "metadata": {"name": "b"},
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole", "name": role},
            "subjects": [{"kind": "ServiceAccount", "name": sa,
                          "namespace": NS}]}


def mk_role(name="r"):
    return {"apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole", "metadata": {"name": name}, "rules": []}


def gpu_job(request, limit=None, name="j"):
    res = {"requests": {GPU: request}} if request is not None else {}
    if limit is not None:
        res["limits"] = {GPU: limit}
    return mk_workload(kind="Job", name=name, pod={"containers": [
        {"name": "c", "image": "img:1", "resources": res}]})


def gang_job(workers, cards, parallelism=None, indexed=True, name="gang"):
    job = gpu_job(str(cards), str(cards), name=name)
    job["spec"]["completions"] = workers
    job["spec"]["parallelism"] = (workers if parallelism is None
                                  else parallelism)
    if indexed:
        job["spec"]["completionMode"] = "Indexed"
    return job


def host_access_job():
    return mk_workload(kind="Job", pod={
        "volumes": [{"name": "h", "hostPath": {"path": "/dev"}}],
        "hostNetwork": True,
        "containers": [{"name": "c", "image": "img:1",
                        "securityContext": {"privileged": True}}]})


def probe_deployment(port):
    return mk_workload(kind="Deployment", pod={"containers": [{
        "name": "c", "image": "img:1",
        "ports": [{"name": "http", "containerPort": 80}],
        "readinessProbe": {"httpGet": {"path": "/", "port": port}}}]})


def cr(crd_group_late):
    """The policy CR, in the CRD's group or a later one."""
    policy = operator_bundle.policy(specmod.default_spec())
    if crd_group_late:
        return [[mk_namespace(), operator_bundle.crd()], [policy]]
    return [[mk_namespace(), operator_bundle.crd(), policy]]


# rule -> (a bundle that must fail, one that must pass); every bundle is
# written with the port's names and linted against the default spec
# (h100-sxm5-80gb-8: 8 cards a host)
CASES = {
    "R01": ([[mk_namespace(), mk_workload(name="dup")],
             [mk_workload(name="dup")]],
            [[mk_namespace(), mk_workload(name="a")],
             [mk_workload(name="b")]]),
    "R02": ([[mk_namespace(), mk_workload(pod={"serviceAccountName": "x"}),
              mk_service({"app": "nothing"})]],
            [[mk_namespace(), mk_sa("x"),
              mk_workload(pod={"serviceAccountName": "x"}),
              mk_service({"app": "work"})]]),
    "R03": ([[mk_namespace(), mk_workload(labels={"app": "x"},
                                          template_labels={"app": "y"})]],
            [[mk_namespace(), mk_workload()]]),
    "R04": (cr(crd_group_late=False), cr(crd_group_late=True)),
    "R05": ([[mk_namespace(), gpu_job("1", "2")]],
            [[mk_namespace(), gpu_job("8", "8")]]),
    "R06": ([[mk_namespace(), mk_workload(image="repo/app:latest")]],
            [[mk_namespace(), mk_workload(image="repo/app:1.2")]]),
    "R07": ([[mk_namespace(), gang_job(2, 8, parallelism=1)]],
            [[mk_namespace(), gang_job(2, 8)]]),
}


def rules_of(findings):
    return {f.rule for f in findings}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rule_has_a_failing_and_a_passing_bundle(rule):
    spec = specmod.default_spec()
    bad, good = CASES[rule]
    findings = lint.lint_groups(bad, spec=spec)
    assert rules_of(findings) == {rule}, [f.line() for f in findings]
    assert lint.errors(findings)
    assert lint.lint_groups(good, spec=spec) == []


# ---------------------------------------------------------------------------
# the same bundles through the reference


def _to_reference(groups):
    text = json.dumps(groups).replace(GPU, "google.com/tpu")
    return json.loads(text.replace(NS, "tpu-system"))


def _keys(findings, ns):
    return sorted((f.rule, f.severity, f.kind,
                   f.namespace.replace(ns, "NS"), f.name, f.path)
                  for f in findings)


SHARED = {
    **{rule: bad for rule, (bad, _) in CASES.items()},
    "R02 configmap, envFrom": [[mk_namespace(), mk_workload(pod={
        "volumes": [{"name": "v", "configMap": {"name": "gone"}}],
        "containers": [{"name": "c", "image": "img:1",
                        "envFrom": [{"configMapRef": {"name": "gone2"}}]}]})]],
    "R02 binding": [[mk_binding()]],
    "R03 versioned selector": [[mk_namespace(), mk_workload(
        labels={"app": "a", "version": "1"})]],
    "R03 Job selector": [[mk_namespace(), dict(
        gpu_job("1", "1"), spec={**gpu_job("1", "1")["spec"],
                                 "selector": {"matchLabels": {"a": "b"}}})]],
    "R04 before its namespace": [[mk_workload(), mk_namespace()]],
    "R04 reference later": [[mk_namespace(),
                             mk_workload(pod={"serviceAccountName": "s"})],
                            [mk_sa("s")]],
    "R05 no limit": [[mk_namespace(), gpu_job("1")]],
    "R05 not whole": [[mk_namespace(), gpu_job("half", "half")]],
    "R05 more than a host": [[mk_namespace(), gpu_job("9", "9")]],
    "R05 host access": [[mk_namespace(), host_access_job()]],
    "R06 untagged": [[mk_namespace(), mk_workload(image="repo/app")]],
    "R06 named probe port": [[mk_namespace(), probe_deployment("web")]],
    "R06 numeric probe port": [[mk_namespace(), probe_deployment(8080)]],
    "R07 not Indexed": [[mk_namespace(), gang_job(2, 8, indexed=False)]],
    "R07 part of a host": [[mk_namespace(), gang_job(2, 4)]],
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rules_match_the_reference_on_mapped_bundles(case):
    groups = SHARED[case]
    got = lint.lint_groups(groups, spec=specmod.default_spec())
    want = ref_lint.lint_groups(_to_reference(groups),
                                spec=ref_specmod.default_spec())
    assert got, case
    assert _keys(got, NS) == _keys(want, "tpu-system")


def test_deviations_r05_range_and_r07_without_slice_tiling():
    spec, ref_spec = specmod.default_spec(), ref_specmod.default_spec()
    # 3 cards of an 8-card host: the reference's v5e-8 takes only its
    # aligned sizes 1, 4, 8; a GPU host takes any count up to its cards
    bundle = [[mk_namespace(), gpu_job("3", "3")]]
    assert rules_of(ref_lint.lint_groups(_to_reference(bundle),
                                         spec=ref_spec)) == {"R05"}
    assert lint.lint_groups(bundle, spec=spec) == []
    [f] = lint.lint_groups([[mk_namespace(), gpu_job("0", "0")]], spec=spec)
    assert (f.rule, f.path) == \
        ("R05", ".spec.template.spec.containers[0].resources")
    assert "outside 1..8 for h100-sxm5-80gb-8" in f.message
    one = specmod.default_spec()
    one.gpu.accelerator = "h100-sxm5-80gb-1"
    assert rules_of(lint.lint_groups([[gpu_job("2", "2")]], spec=one)) == \
        {"R05"}
    # 3 whole hosts: no v5e slice has 3 hosts; GPU hosts tile none at all
    bundle = [[mk_namespace(), gang_job(3, 8)]]
    [ref_f] = ref_lint.lint_groups(_to_reference(bundle), spec=ref_spec)
    assert (ref_f.rule, ref_f.path) == ("R07", ".spec.completions")
    assert lint.lint_groups(bundle, spec=spec) == []
    # without a spec neither range nor gang shape is known
    assert lint.lint_groups([[gpu_job("9", "9")]]) == []


def test_allow_annotation_waives_warnings_only():
    job = host_access_job()
    assert {f.severity for f in lint.lint_groups([[job]])} == {"warn"}
    job["metadata"]["annotations"] = {
        lint.LINT_ALLOW_ANNOTATION: "hostPath, hostNetwork, privileged"}
    assert lint.lint_groups([[job]]) == []
    job["spec"]["template"]["spec"]["containers"][0]["resources"] = {
        "requests": {GPU: "1"}, "limits": {GPU: "2"}}
    fs = lint.lint_groups([[job]], spec=specmod.default_spec())
    assert [(f.rule, f.severity) for f in fs] == [("R05", "error")]
    # operand workloads carrying the stack's identity label are exempt
    ds = mk_workload(pod=host_access_job()["spec"]["template"]["spec"])
    ds["metadata"]["labels"] = {"app.kubernetes.io/part-of": "tpu-stack"}
    assert lint.lint_groups([[mk_namespace(), ds]]) == []


def test_findings_sort_errors_first_and_table():
    bundle = [[mk_namespace(), mk_workload(image="repo/app:latest"),
               mk_workload(kind="Job", name="j", pod={
                   "volumes": [{"name": "h",
                                "hostPath": {"path": "/x"}}]})]]
    fs = lint.lint_groups(bundle)
    assert [f.severity for f in fs] == ["error", "warn"]
    assert lint.format_table(fs).splitlines()[-1] == \
        "lint: 1 error(s), 1 warning(s)"
    assert [f.to_dict() for f in fs] == [
        f.to_dict() for f in ref_lint.lint_groups(
            json.loads(json.dumps(bundle)))]


def test_gate_modes():
    bad = CASES["R06"][0]
    logged = []
    assert lint.gate(bad, "off") == []
    assert rules_of(lint.gate(bad, "warn", log=logged.append)) == {"R06"}
    assert logged[-1].startswith("lint: 1 error(s), 0 warning(s)")
    with pytest.raises(lint.LintGateError) as err:
        lint.gate(bad, "error")
    assert isinstance(err.value, lint.ApplyError)
    assert "nothing was applied" in str(err.value)
    assert lint.gate(CASES["R06"][1], "error") == []
    with pytest.raises(ValueError):
        lint.gate(bad, "loud")


# ---------------------------------------------------------------------------
# the port's copies of the reference's tables


def test_tier_and_scope_tables_equal_the_reference_apply_engine():
    assert lint._TIER_FIRST is kubeapply._TIER_FIRST
    assert lint.WORKLOAD_KINDS is kubeapply.WORKLOAD_KINDS
    assert lint._KINDS is kubeapply._KINDS
    assert lint.ApplyError is kubeapply.ApplyError
    assert kubeapply._TIER_FIRST == ref_kubeapply._TIER_FIRST
    assert kubeapply.WORKLOAD_KINDS == ref_kubeapply.WORKLOAD_KINDS
    assert kubeapply._KINDS == ref_kubeapply._KINDS
    group = [mk_namespace(), operator_bundle.crd(), mk_sa("s"),
             mk_configmap("c"), mk_workload(name="d"),
             mk_workload(kind="Deployment", name="dep"),
             mk_workload(kind="Job", name="j")]
    want = [[o for o in group if lint._tier_index(o) == t]
            for t in (0, 1, 2)]
    assert ref_kubeapply._group_tiers(group) == [t for t in want if t]
    for name in ("DEFAULT_EXTERNAL", "OPERAND_WORKLOAD_KINDS",
                 "POD_TEMPLATE_KINDS", "BUILTIN_API_VERSIONS",
                 "VERSIONISH_SELECTOR_KEYS", "LINT_ALLOW_ANNOTATION"):
        assert getattr(lint, name) == getattr(ref_lint, name), name
    assert operator_bundle.OPERAND_LABEL == lint._OPERAND_LABEL \
        == ref_bundle.OPERAND_LABEL


def test_operand_workload_table_pins_the_native_operator_source():
    with open(os.path.join(REPO, "native", "operator", "kubeapi.cc"),
              encoding="utf-8") as f:
        src = f.read()
    m = re.search(
        r"OperandWorkloadKinds\(\)\s*\{.*?vector<std::string>\{([^}]*)\}",
        src, re.S)
    assert m
    assert set(re.findall(r'"([A-Za-z]+)"', m.group(1))) == \
        {kind for _, kind in lint.OPERAND_WORKLOAD_KINDS}


# ---------------------------------------------------------------------------
# self-audit: everything the port renders lints clean in strict mode


@pytest.mark.parametrize("acc", ["h100-sxm5-80gb-1", "h100-sxm5-80gb-8"])
def test_everything_rendered_lints_clean_for_every_operand_switch(acc):
    names = specmod.GpuSpec.OPERAND_NAMES
    for bits in range(2 ** len(names)):
        spec = specmod.default_spec()
        spec.gpu.accelerator = acc
        spec.gpu.operands = {
            name: specmod.OperandSpec(enabled=bool(bits >> i & 1))
            for i, name in enumerate(names)}
        spec.validate()
        for groups in (manifests.rollout_groups(spec),
                       operator_bundle.operator_install_groups(spec),
                       [jobs.render_validation_jobs(spec.gpu, 2)]):
            findings = lint.lint_groups(groups, spec=spec)
            assert findings == [], (acc, bits, [f.line() for f in findings])


def test_render_and_lint_with_pyyaml_blocked():
    """The card's machine has no PyYAML: the spec, every renderer, the
    linter and the CLI's lint import and run without it."""
    code = (
        "import sys, json\n"
        "sys.modules['yaml'] = None  # any import of it now fails\n"
        "from tpu_cluster_torch import __main__ as cli, lint\n"
        "from tpu_cluster_torch.render import (jobs, kubeadm, manifests,\n"
        "    nodeprep, operator_bundle)\n"
        "from tpu_cluster_torch.spec import default_spec\n"
        "import chip_smoke\n"
        "spec = default_spec()\n"
        "spec.gpu.accelerator = 'h100-sxm5-80gb-1'\n"
        "spec.validate()\n"
        "bundles = [manifests.rollout_groups(spec),\n"
        "           operator_bundle.operator_install_groups(spec),\n"
        "           [jobs.render_validation_jobs(spec.gpu, 2)]]\n"
        "n = 0\n"
        "for groups in bundles:\n"
        "    assert lint.lint_groups(groups, spec=spec) == []\n"
        "    n += sum(len(g) for g in groups)\n"
        "json.dumps(operator_bundle.bundle_files(spec))\n"
        "for render in (nodeprep.render_node_prep,\n"
        "               nodeprep.render_kubeadm_packages,\n"
        "               kubeadm.render_init_script):\n"
        "    assert render(spec).startswith('#!/usr/bin/env bash')\n"
        "assert cli.main(['lint', '--strict']) == 0\n"
        "assert cli.main(['lint', '--strict', '--operator']) == 0\n"
        "assert 'yaml' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print('ok', n)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "ok 27"


# ---------------------------------------------------------------------------
# the CLI


def test_cli_lint_default_bundle_strict_clean(capsys):
    assert cli.main(["lint", "--strict"]) == 0
    assert cli.main(["lint", "--strict", "--operator"]) == 0
    assert "0 error(s), 0 warning(s)" in capsys.readouterr().out
    out = subprocess.run([sys.executable, "-m", "tpu_cluster_torch", "lint",
                          "--format", "json"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert (doc["ok"], doc["errors"], doc["warnings"]) == (True, 0, 0)


def test_cli_lint_exits_1_on_a_broken_gpu_request(monkeypatch, capsys):
    bad = [[mk_namespace(), gpu_job("1", "2")]]
    monkeypatch.setattr(cli.manifests, "rollout_groups", lambda spec: bad)
    assert cli.main(["lint"]) == 1
    err = capsys.readouterr().err
    assert "R05" in err and "nvidia.com/gpu request (1) != limit (2)" in err
    assert cli.main(["lint", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is False and doc["errors"] == 1
    [f] = doc["findings"]
    assert (f["rule"], f["path"]) == \
        ("R05", ".spec.template.spec.containers[0].resources")


def test_cli_lint_strict_and_allow_external(monkeypatch, capsys):
    warn_only = [[mk_namespace(), mk_workload(
        kind="Job", name="j",
        pod={"volumes": [{"name": "h", "hostPath": {"path": "/x"}}]})]]
    monkeypatch.setattr(cli.manifests, "rollout_groups",
                        lambda spec: warn_only)
    assert cli.main(["lint"]) == 0
    assert cli.main(["lint", "--strict"]) == 1
    assert "R05" in capsys.readouterr().err
    dangling = [[mk_namespace(),
                 mk_workload(pod={"serviceAccountName": "prom"})]]
    monkeypatch.setattr(cli.manifests, "rollout_groups",
                        lambda spec: dangling)
    assert cli.main(["lint"]) == 1
    assert cli.main(["lint", "--allow-external",
                     "ServiceAccount/*/prom"]) == 0


def test_cli_lint_spec_errors_exit_2(tmp_path, capsys):
    path = tmp_path / "spec.yaml"
    path.write_text("gpu: {operands: {warpDrive: true}}\n")
    assert cli.main(["lint", "--spec", str(path)]) == 2
    assert "spec error: unknown operand 'warpDrive'" in \
        capsys.readouterr().err
    assert cli.main(["lint", "--spec", str(tmp_path / "none.yaml")]) == 2
    path.write_text("gpu: {accelerator: h100-sxm5-80gb-1, operands: "
                    "{devicePlugin: false}}\n")
    assert cli.main(["lint", "--strict", "--spec", str(path)]) == 0
