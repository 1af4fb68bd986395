"""The port's Helm chart (``deploy/chart/gpu-stack``), its generator
(``tpu_cluster_torch.render.chart``) and its template renderer
(``tpu_cluster_torch.render.gotmpl``).

Held exactly: the checked-in chart equals a fresh generation (``--check``
exits 0); rendered through the port's ``gotmpl`` with the default values,
the chart equals the port's operand manifests object for object; each
operand switch removes exactly its documents; ``--set`` of accelerator,
image and namespace reaches every flag and field derived from it; the
operator template's policy CR and bundle track the switches; and the
port's ``gotmpl`` renders every template of both charts as the
reference's does. The reference's chart stays byte-identical to the
reference's generator's output.
"""

import json
import os
import subprocess
import sys

import pytest

from tpu_cluster.render import gotmpl as ref_gotmpl
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch import topology
from tpu_cluster_torch.render import chart, gotmpl, manifests, operator_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHART = chart.CHART_DIR
REF_CHART = os.path.join(REPO, "deploy", "chart", "tpu-stack")

OPERAND_DOC_NAMES = {
    # switch -> exactly the (kind, name) docs it controls
    "driverPrep": {("DaemonSet", "gpu-driver-prep")},
    "devicePlugin": {("DaemonSet", "gpu-device-plugin")},
    "featureDiscovery": {
        ("ServiceAccount", "gpu-feature-discovery"),
        ("ClusterRole", "gpu-feature-discovery"),
        ("ClusterRoleBinding", "gpu-feature-discovery"),
        ("DaemonSet", "gpu-feature-discovery"),
    },
    "metricsExporter": {("DaemonSet", "gpu-metrics-exporter"),
                        ("Service", "gpu-metrics-exporter")},
    "nodeStatusExporter": {("DaemonSet", "gpu-node-status-exporter")},
}


def kindnames(docs):
    return {(d["kind"], d["metadata"]["name"]) for d in docs}


def test_checked_in_chart_is_in_sync():
    assert chart.check_chart(CHART) == []
    proc = subprocess.run([sys.executable, "-m",
                           "tpu_cluster_torch.render.chart", "--check"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "chart: in sync"


def test_check_reports_drift(tmp_path):
    chart.write_chart(str(tmp_path))
    assert chart.check_chart(str(tmp_path)) == []
    path = tmp_path / "templates" / "20-device-plugin.yaml"
    path.write_text(path.read_text().replace("privileged: true",
                                             "privileged: false"))
    (tmp_path / "values.yaml").unlink()
    problems = chart.check_chart(str(tmp_path))
    assert problems[0] == "missing: values.yaml"
    assert problems[1].startswith("drift in templates/20-device-plugin.yaml")
    assert chart.main(["--check", "--out", str(tmp_path)]) == 1


def test_default_render_equals_the_ports_manifests():
    docs = gotmpl.render_chart(CHART)
    want = manifests.render_objects(specmod.default_spec())
    assert docs == want


def test_operator_enabled_renders_the_operator_install():
    spec = specmod.default_spec()
    docs = gotmpl.render_chart(CHART, {"operator": {"enabled": True}})
    want = [o for o in operator_bundle.operator_install(spec)[1:]
            if o["kind"] != "CustomResourceDefinition"]
    got = docs[len(docs) - len(want):]
    assert kindnames(got) == kindnames(want)
    for g, w in zip(got, want):
        if w["kind"] != "ConfigMap":
            assert g == w
    # the bundle's operands carry the switches' install-time intent
    cm = next(d for d in got if d["kind"] == "ConfigMap")
    for text in cm["data"].values():
        doc = json.loads(text)
        if operator_bundle.OPERAND_LABEL in doc["metadata"].get("labels", {}):
            assert doc["metadata"]["annotations"][
                operator_bundle.DEFAULT_ENABLED_ANNOTATION] == "true"
    bundle = {k: json.loads(v) for k, v in cm["data"].items()}
    for obj in bundle.values():
        obj["metadata"].get("annotations", {}).pop(
            operator_bundle.DEFAULT_ENABLED_ANNOTATION, None)
        if not obj["metadata"].get("annotations", True):
            del obj["metadata"]["annotations"]
    assert bundle == operator_bundle.bundle_files(spec)


def test_switches_reach_the_policy_cr_and_the_bundle_intent():
    docs = gotmpl.render_chart(CHART, {"operator": {"enabled": True},
                                       "metricsExporter": {"enabled": False}})
    cr = next(d for d in docs if d["kind"] == "TpuStackPolicy")
    assert cr["spec"]["operands"]["metricsExporter"] == {"enabled": False}
    assert cr["spec"]["operands"]["driverPrep"] == {"enabled": True}
    assert set(cr["spec"]["operands"]) == set(OPERAND_DOC_NAMES)
    cm = next(d for d in docs if d["kind"] == "ConfigMap")
    intent = {}
    for text in cm["data"].values():
        meta = json.loads(text)["metadata"]
        operand = meta.get("labels", {}).get(operator_bundle.OPERAND_LABEL)
        if operand:
            intent.setdefault(operand, set()).add(meta["annotations"][
                operator_bundle.DEFAULT_ENABLED_ANNOTATION])
    assert intent.pop("metricsExporter") == {"false"}
    assert all(v == {"true"} for v in intent.values())


def test_the_crd_ships_in_crds_only():
    import yaml

    with open(os.path.join(CHART, "crds", "tpustackpolicy.yaml"),
              encoding="utf-8") as f:
        assert yaml.safe_load(f) == operator_bundle.crd()
    tdir = os.path.join(CHART, "templates")
    for name in os.listdir(tdir):
        with open(os.path.join(tdir, name), encoding="utf-8") as f:
            assert "CustomResourceDefinition" not in f.read(), name


@pytest.mark.parametrize("switch", sorted(OPERAND_DOC_NAMES))
def test_each_switch_removes_exactly_its_documents(switch):
    on = kindnames(gotmpl.render_chart(CHART))
    off = kindnames(gotmpl.render_chart(CHART, {switch: {"enabled": False}}))
    assert on - off == OPERAND_DOC_NAMES[switch]
    assert off < on


def test_create_namespace_switch():
    docs = gotmpl.render_chart(CHART, {"createNamespace": False})
    assert ("Namespace", "gpu-system") not in kindnames(docs)
    assert len(docs) == len(gotmpl.render_chart(CHART)) - 1


def test_set_reaches_flags_images_and_namespace():
    """``--set`` of the accelerator, image and namespace gives what the
    port renders for a spec with those values."""
    overrides = {}
    gotmpl.set_value(overrides, "accelerator", "h100-sxm5-80gb-1")
    gotmpl.set_value(overrides, "image", "example.com/custom:9")
    gotmpl.set_value(overrides, "namespace", "gpu-alt")
    docs = gotmpl.render_chart(CHART, overrides)
    spec = specmod.ClusterSpec(gpu=specmod.GpuSpec(
        accelerator="h100-sxm5-80gb-1", image="example.com/custom:9",
        namespace="gpu-alt")).validate()
    assert docs == manifests.render_objects(spec)
    gfd = next(d for d in docs if d["kind"] == "DaemonSet"
               and d["metadata"]["name"] == "gpu-feature-discovery")
    args = gfd["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--accelerator=h100-sxm5-80gb-1" in args
    # the device plugin, dcgm-exporter and the validator keep NVIDIA's
    # pinned images
    images = {d["metadata"]["name"]:
              d["spec"]["template"]["spec"]["containers"][0]["image"]
              for d in docs if d["kind"] == "DaemonSet"}
    assert images["gpu-driver-prep"] == "example.com/custom:9"
    assert images["gpu-device-plugin"] == \
        manifests.DEFAULT_IMAGES["devicePlugin"]


def test_values_schema_covers_the_values():
    with open(os.path.join(CHART, "values.schema.json"),
              encoding="utf-8") as f:
        schema = json.load(f)
    import yaml

    with open(os.path.join(CHART, "values.yaml"), encoding="utf-8") as f:
        values = yaml.safe_load(f)
    props = schema["properties"]
    assert set(values) <= set(props)
    assert set(props) - set(values) == {"global"}
    assert schema["additionalProperties"] is False
    assert props["accelerator"]["enum"] == sorted(topology.HOST_TYPES)
    assert values["accelerator"] in props["accelerator"]["enum"]
    assert values["namespace"] == "gpu-system"
    for name in (*OPERAND_DOC_NAMES, "operator"):
        assert props[name]["properties"] == {"enabled": {"type": "boolean"}}
        assert isinstance(values[name]["enabled"], bool)


def _templates(chart_dir):
    tdir = os.path.join(chart_dir, "templates")
    for name in sorted(os.listdir(tdir)):
        with open(os.path.join(tdir, name), encoding="utf-8") as f:
            yield name, f.read()


@pytest.mark.parametrize("chart_dir", [CHART, REF_CHART],
                         ids=["gpu-stack", "tpu-stack"])
def test_gotmpl_renders_like_the_reference(chart_dir):
    import yaml

    with open(os.path.join(chart_dir, "values.yaml"), encoding="utf-8") as f:
        values = yaml.safe_load(f)
    for name, text in _templates(chart_dir):
        for flip in (None, *[k for k, v in values.items()
                             if isinstance(v, dict)]):
            vals = (values if flip is None else
                    gotmpl.deep_merge(values, {flip: {"enabled": False}}))
            assert gotmpl.render(text, vals) == ref_gotmpl.render(text, vals)
    assert gotmpl.render_chart(chart_dir) == ref_gotmpl.render_chart(
        chart_dir)


def test_gotmpl_is_strict():
    for text, values in (("{{- if .Values.x }}\nnever closed\n", {"x": 1}),
                         ("text\n{{- end }}\n", {}),
                         ('{{ include "helper" . }}', {}),
                         ("{{ .Values.nope }}", {}),
                         ("{{ .Release.Namespace }}", {})):
        with pytest.raises(gotmpl.TemplateError):
            gotmpl.render(text, values)
    assert gotmpl.render("a\n  {{- if .Values.on }}\nb\n{{- end }}\nc\n",
                         {"on": True}) == "a\nb\nc\n"
    assert gotmpl.render("{{ .Values.b }}", {"b": False}) == "false"


def test_chart_and_gotmpl_import_without_pyyaml():
    code = ("import sys\n"
            "sys.modules['yaml'] = None\n"
            "from tpu_cluster_torch.render import chart, gotmpl\n"
            "assert gotmpl.render('{{ .Values.a }}', {'a': 1}) == '1'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
