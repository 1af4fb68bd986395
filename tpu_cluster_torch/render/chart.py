"""Generate the gpu-stack umbrella Helm chart from the port's renderers:
the counterpart of the reference's ``scripts/gen_chart.py``.

The GPU Operator installs its stack with one ``helm install --wait --set
driver.enabled=true ...``. This chart gives the port's stack the same
install. The templates are NOT hand-written: they are generated from
:mod:`.manifests` and :mod:`.operator_bundle` (the single source of truth
the operator bundle and ``apply`` also use) with sentinel values swapped
for go-template expressions, so the chart cannot drift from the code —
``--check`` regenerates and diffs.

Values: ``namespace``, ``createNamespace``, ``image`` (the port's image:
driver prep and feature discovery; the device plugin, dcgm-exporter and
the validator keep their pinned NVIDIA images), ``accelerator`` (a host
layout of :data:`..topology.HOST_TYPES`), one ``<operand>.enabled``
switch per operand and ``operator.enabled``.

    python -m tpu_cluster_torch.render.chart [--check] [--out DIR]

PyYAML is imported only inside the functions that write YAML.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import sys
from typing import Any, Dict, List

from .. import topology
from ..spec import ClusterSpec, GpuSpec
from . import manifests, operator_bundle

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHART_DIR = os.path.join(REPO, "deploy", "chart", "gpu-stack")

# Sentinels: valid-looking values that cannot collide with real content.
NS_SENTINEL = "helmns-sentinel"
IMG_SENTINEL = "helm-img-sentinel:0"

OPERANDS = GpuSpec.OPERAND_NAMES
DEFAULT_ACCELERATOR = GpuSpec.accelerator

SUBS = [
    (NS_SENTINEL, "{{ .Values.namespace }}"),
    (IMG_SENTINEL, "{{ .Values.image }}"),
    # Flag-anchored (never a blind value replace, which would corrupt any
    # manifest content that happened to contain the layout's name). It is
    # the only flag the manifests derive from the accelerator, so
    # `--set accelerator=...` leaves no stale value behind.
    (f"--accelerator={DEFAULT_ACCELERATOR}",
     "--accelerator={{ .Values.accelerator }}"),
] + [
    # The TpuStackPolicy CR's operand booleans track the chart switches, so
    # in operator mode `--set metricsExporter.enabled=false` reaches the
    # controller at runtime through the CR (ClusterPolicy analog) instead of
    # being frozen at render time. Anchored on the CR's exact YAML shape
    # (4/6-space indent) so the CRD schema and bundle JSON can't match.
    (f"    {name}:\n      enabled: true",
     f"    {name}:\n      enabled: {{{{ .Values.{name}.enabled }}}}")
    for name in OPERANDS
] + [
    # Bundle-ConfigMap default-enabled annotations (see
    # _operator_objs_with_helm_intent): fail-open must revert to the
    # HELM-INSTALLED state, so the install-time intent inside the bundle
    # JSON tracks the same chart switches.
    (f"helm-denabled-{name}", f"{{{{ .Values.{name}.enabled }}}}")
    for name in OPERANDS
]

CHART_YAML = """\
apiVersion: v2
name: gpu-stack
description: >-
  GPU enablement for kubeadm clusters - driver check, NVIDIA device plugin,
  feature discovery, dcgm-exporter and node status exporter, with an
  optional in-cluster operator. Generated by
  python -m tpu_cluster_torch.render.chart; do not edit templates by hand.
type: application
version: 0.1.0
appVersion: "0.1.0"
"""

HELPERS_TPL = """\
{{/* Generated by python -m tpu_cluster_torch.render.chart - regenerate, \
don't edit. */}}
"""

# template file -> (renderer, operand switch); the CR, bundle and operator
# Deployment ride 50-operator.yaml
TEMPLATES = (
    ("10-driver-prep.yaml", "driverPrep"),
    ("20-device-plugin.yaml", "devicePlugin"),
    ("30-feature-discovery.yaml", "featureDiscovery"),
    ("40-metrics-exporter.yaml", "metricsExporter"),
    ("41-node-status-exporter.yaml", "nodeStatusExporter"),
)
_RENDERERS = {
    "driverPrep": lambda s: [manifests.driver_prep(s)],
    "devicePlugin": lambda s: [manifests.device_plugin(s)],
    "featureDiscovery": manifests.feature_discovery,
    "metricsExporter": manifests.metrics_exporter,
    "nodeStatusExporter": lambda s: [manifests.node_status_exporter(s)],
}


def values_yaml() -> str:
    """The chart's defaults: the port's default spec."""
    defaults = GpuSpec()
    switches = "".join(f"{name}:\n  enabled: true\n" for name in OPERANDS)
    return (
        "# Per-operand switches - the GPU Operator's `helm --set` surface.\n"
        f"namespace: {defaults.namespace}\n"
        "createNamespace: true\n"
        f"accelerator: {defaults.accelerator}\n"
        f"image: {defaults.image}\n"
        "\n"
        f"{switches}"
        "operator:\n"
        "  enabled: false         # in-cluster controller instead of "
        "helm-only rollout\n")


def _sentinel_spec() -> ClusterSpec:
    return ClusterSpec(gpu=GpuSpec(namespace=NS_SENTINEL,
                                   image=IMG_SENTINEL)).validate()


def _operator_objs_with_helm_intent(spec: ClusterSpec) -> List[Dict[str, Any]]:
    """Operator-mode objects for the chart, with the bundle ConfigMap's
    per-operand ``default-enabled`` annotations carrying helm-values
    sentinels. The CLI path stamps this annotation from the spec at render
    time; the chart's bundle is rendered from the all-enabled sentinel
    spec, so without this a helm-disabled operand carried no install-time
    intent and a later TpuStackPolicy deletion fail-OPENED it into
    existence. The sentinel becomes ``{{ .Values.<operand>.enabled }}``
    via SUBS; the operator only treats the literal string "false" as
    disabled, so a rendered "true" is equivalent to the annotation being
    absent."""
    objs = [o for o in operator_bundle.operator_install(spec)[1:]
            if o["kind"] != "CustomResourceDefinition"]
    for obj in objs:
        if obj.get("kind") != "ConfigMap" or "data" not in obj:
            continue
        for fname, text in list(obj["data"].items()):
            doc = json.loads(text)
            operand = ((doc.get("metadata") or {}).get("labels") or {}).get(
                operator_bundle.OPERAND_LABEL)
            if not operand:
                continue
            doc["metadata"].setdefault("annotations", {})[
                operator_bundle.DEFAULT_ENABLED_ANNOTATION] = (
                f"helm-denabled-{operand}")
            obj["data"][fname] = json.dumps(doc, indent=2)
    return objs


def _templatize(objs: List[Dict[str, Any]], guard: str) -> str:
    import yaml

    text = yaml.dump_all(objs, sort_keys=False)
    for sentinel, expr in SUBS:
        text = text.replace(sentinel, expr)
    if guard:
        return f"{{{{- if {guard} }}}}\n{text}{{{{- end }}}}\n"
    return text


def render_chart_files() -> Dict[str, str]:
    import yaml

    spec = _sentinel_spec()
    files: Dict[str, str] = {
        "Chart.yaml": CHART_YAML,
        "values.yaml": values_yaml(),
        "templates/_helpers.tpl": HELPERS_TPL,
        "templates/00-namespace.yaml": _templatize(
            [manifests.namespace(spec)], ".Values.createNamespace"),
    }
    for fname, operand in TEMPLATES:
        files[f"templates/{fname}"] = _templatize(
            _RENDERERS[operand](spec), f".Values.{operand}.enabled")
    # ns handled above; the CRD ships in crds/ (below), which Helm
    # installs and settles BEFORE templates — rendering the TpuStackPolicy
    # CR next to its CRD in one template would race CRD establishment
    # ("no matches for kind") on first install
    files["templates/50-operator.yaml"] = _templatize(
        _operator_objs_with_helm_intent(spec), ".Values.operator.enabled")
    files["crds/tpustackpolicy.yaml"] = yaml.dump(operator_bundle.crd(),
                                                  sort_keys=False)
    files["values.schema.json"] = _values_schema()
    return files


def _values_schema() -> str:
    """JSON Schema helm validates user values against on lint/install —
    catches `--set devicPlugin.enabled=true` typos at install time. The
    accelerator enum comes from the catalogue's host layouts, so
    regeneration keeps it in step with new layouts."""
    switch = {"type": "object",
              "properties": {"enabled": {"type": "boolean"}},
              "additionalProperties": False}
    schema = {
        "$schema": "https://json-schema.org/draft-07/schema#",
        "type": "object",
        "properties": {
            "namespace": {"type": "string", "minLength": 1},
            "createNamespace": {"type": "boolean"},
            "accelerator": {"type": "string",
                            "enum": sorted(topology.HOST_TYPES)},
            "image": {"type": "string", "minLength": 1},
            **{name: dict(switch) for name in (*OPERANDS, "operator")},
            # helm reserves this for subchart plumbing
            "global": {"type": "object"},
        },
        "additionalProperties": False,
    }
    return json.dumps(schema, indent=2) + "\n"


def write_chart(out_dir: str) -> List[str]:
    written = []
    for rel, text in render_chart_files().items():
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        written.append(path)
    return written


def check_chart(chart_dir: str) -> List[str]:
    """Return a list of drift diagnostics; empty = in sync."""
    problems = []
    for rel, want in render_chart_files().items():
        path = os.path.join(chart_dir, rel)
        if not os.path.exists(path):
            problems.append(f"missing: {rel}")
            continue
        with open(path, encoding="utf-8") as f:
            have = f.read()
        if have != want:
            diff = "".join(difflib.unified_diff(
                have.splitlines(keepends=True),
                want.splitlines(keepends=True),
                fromfile=f"checked-in/{rel}", tofile=f"generated/{rel}"))
            problems.append(f"drift in {rel}:\n{diff}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_cluster_torch.render.chart")
    ap.add_argument("--check", action="store_true",
                    help="verify the checked-in chart matches; don't write")
    ap.add_argument("--out", default=CHART_DIR)
    args = ap.parse_args(argv)
    if args.check:
        problems = check_chart(args.out)
        for p in problems:
            print(p)
        print("chart: " + ("DRIFT" if problems else "in sync"))
        return 1 if problems else 0
    for path in write_chart(args.out):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
