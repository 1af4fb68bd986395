"""The contract registry: every cross-process constant, declared once.
The port's own copy of ``tpu_cluster/contracts.py``, over the port's
live constants.

The stack's correctness story leans on names that must agree across
processes that never link against each other — metric family names the
native operator's ``/metrics`` endpoint emits and the Python scrape
pipeline parses, Chrome-trace slice names three producers must spell
identically for one merged timeline, annotation keys the CLI stamps and
the operator reads back, Event reasons the controllers post and the
runbooks grep for, ConfigMap names the controllers LIST and PATCH, chaos
kinds the fault scripts and the soak tests share.

This module is the declarative half: one machine-readable table of
:class:`Contract` records, each naming

- the canonical **value** and its Python declaration locus (the
  constants themselves live in their owning modules —
  ``telemetry.OPERATOR_METRIC_NAMES``, ``admission.GANG_ANNOTATION`` —
  and the registry IMPORTS them, so the spelling has exactly one
  source);
- the **C++ twin** accessor, when one exists. The GPU stack still runs
  the reference's native operator, so its accessors stay pinned:
  ``kubeapi::OperatorMetricNames()``, ``OperatorTraceEventNames()``,
  ``TraceparentAnnotation()``, ``FieldManager()``,
  ``OperandWorkloadKinds()``, the ``Plurals()`` map and
  ``kubeclient::RetryableStatus``'s cases, which
  :mod:`tpu_cluster_torch.pinlint` statically extracts and diffs. The
  GPU stack runs NVIDIA's device plugin and the port's labeler, not the
  native ``tpud`` and ``tfd_main``, so the reservation table, the gang
  annotation and the ``nvidia.com/gpu.*`` labels carry no C++ pin; their
  enforcers are the port's own modules that write them;
- the **enforcement files** that must mention the value verbatim;
- the **docs** that claim coverage, as repo-relative paths: a name the
  port shares with the reference keeps ``docs/GUIDE.md``, a GPU name is
  documented in ``README.md``'s contract table.

The checking half is :mod:`tpu_cluster_torch.pinlint` (``python -m
tpu_cluster_torch pinlint``): it diffs this registry against the
extracted C++ side, harvests contract-shaped constants from the port's
sources to catch UNDECLARED ones, and cross-checks docs and CI.
``pinlint --dump`` prints the registry as JSON.

Adding a contract = adding the constant to its owning module plus one
``Contract`` entry here; pinlint's harvest fails until the entry exists.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# Contract kinds (the registry's vocabulary; pinlint reports them and
# `--dump` consumers filter on them).
KIND_METRIC_FAMILY = "metric-family"
KIND_TRACE_SLICE = "trace-slice"
KIND_ANNOTATION = "annotation"
KIND_LABEL = "label"
KIND_EVENT_REASON = "event-reason"
KIND_EVENT_TYPE = "event-type"
KIND_CONFIGMAP = "configmap"
KIND_CONFIGMAP_KEY = "configmap-key"
KIND_SCHEMA_VERSION = "schema-version"
KIND_PHASE = "phase"
KIND_STATUS = "status"
KIND_CHAOS_KIND = "chaos-kind"
KIND_FIELD_MANAGER = "field-manager"
KIND_RESOURCE = "resource"
KIND_PLURAL = "plural"
KIND_RETRYABLE_STATUS = "retryable-status"
KIND_WORKLOAD_KIND = "workload-kind"
KIND_EVENT_COMPONENT = "event-component"

ALL_KINDS: Tuple[str, ...] = (
    KIND_METRIC_FAMILY, KIND_TRACE_SLICE, KIND_ANNOTATION, KIND_LABEL,
    KIND_EVENT_REASON, KIND_EVENT_TYPE, KIND_CONFIGMAP,
    KIND_CONFIGMAP_KEY, KIND_SCHEMA_VERSION, KIND_PHASE, KIND_STATUS,
    KIND_CHAOS_KIND, KIND_FIELD_MANAGER, KIND_RESOURCE, KIND_PLURAL,
    KIND_RETRYABLE_STATUS, KIND_WORKLOAD_KIND, KIND_EVENT_COMPONENT)

# The chaos-script fault kinds (docs/TESTING.md "Chaos engine"); the
# port's tests drive the same fake apiserver, so they stay as they are. The
# request-fault kinds are spelled as script DICT KEYS in
# tests/fake_apiserver.py (``{"drop": 2}``), the node-lifecycle kinds as
# the ``_NODE_FAULT_KINDS`` tuple — pinlint extracts that tuple and
# checks it against this registry, and checks every kind here appears
# verbatim in the fake's source. Declared HERE (not imported) because
# the package must not import test code; the cross-check is what keeps
# the two spellings equal.
CHAOS_REQUEST_KINDS: Tuple[str, ...] = (
    "drop", "stall", "trickle", "truncate", "garbage", "flap")
CHAOS_NODE_KINDS: Tuple[str, ...] = (
    "node_not_ready", "node_ready", "evict_pods",
    "cordon_node", "uncordon_node")
CHAOS_KINDS: Tuple[str, ...] = CHAOS_REQUEST_KINDS + CHAOS_NODE_KINDS

# Repo-relative path of the chaos engine's source (the harvest/extract
# target for the chaos-kind contracts above).
FAKE_APISERVER_PATH = "tests/fake_apiserver.py"


@dataclass(frozen=True)
class CppPin:
    """A statically-extractable C++ accessor that must return (or
    tabulate) a contract value.

    ``file`` is repo-relative; ``symbol`` is the accessor function name
    (``OperatorMetricNames``). ``index`` >= 0 marks one row of a string
    TABLE (``new std::vector<std::string>{...}``) — pinlint compares
    whole tables ordered. ``integer`` marks a ``return <int>;``
    accessor. ``key`` marks one entry of a string MAP (``{"Kind",
    "plural"}`` rows of ``new std::map<std::string, std::string>{...}``):
    the entry under ``key`` must equal the value. ``case`` marks one
    ``case N:`` label of a switch that returns true — pinlint compares
    the whole label set."""

    file: str
    symbol: str
    index: int = -1
    integer: bool = False
    key: str = ""
    case: bool = False


@dataclass(frozen=True)
class Contract:
    """One registered cross-process constant."""

    name: str                 # unique registry id: "<kind>/<value-ish>"
    kind: str
    value: str                # canonical spelling (ints via str())
    py_file: str              # repo-relative declaring source
    py_attr: str              # "NAME" or "NAME[i]" ("" = literal/dict key)
    cpp: Optional[CppPin] = None
    # repo-relative files that must contain `value` verbatim
    enforcers: Tuple[str, ...] = ()
    # repo-relative docs that must mention `value` (coverage claims)
    docs: Tuple[str, ...] = ()

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "name": self.name, "kind": self.kind, "value": self.value,
            "py_file": self.py_file, "py_attr": self.py_attr,
            "enforcers": list(self.enforcers), "docs": list(self.docs),
        }
        if self.cpp is not None:
            out["cpp"] = {"file": self.cpp.file, "symbol": self.cpp.symbol,
                          "index": self.cpp.index,
                          "integer": self.cpp.integer,
                          "key": self.cpp.key, "case": self.cpp.case}
        return out


class Registry:
    """The assembled contract table, with the lookups pinlint needs."""

    def __init__(self, contracts: Sequence[Contract]) -> None:
        self.contracts: Tuple[Contract, ...] = tuple(contracts)
        self._by_name: Dict[str, Contract] = {}
        for c in self.contracts:
            if c.name in self._by_name:
                raise ValueError(f"duplicate contract name: {c.name}")
            self._by_name[c.name] = c

    def get(self, name: str) -> Contract:
        return self._by_name[name]

    def values(self, kind: Optional[str] = None) -> frozenset[str]:
        return frozenset(c.value for c in self.contracts
                         if kind is None or c.kind == kind)

    def by_kind(self, kind: str) -> List[Contract]:
        return [c for c in self.contracts if c.kind == kind]

    def cpp_tables(self) -> Dict[Tuple[str, str], List[Contract]]:
        """{(cpp file, symbol): ordered table rows} for every
        table-pinned contract group (index >= 0)."""
        out: Dict[Tuple[str, str], List[Contract]] = {}
        for c in self.contracts:
            if c.cpp is not None and c.cpp.index >= 0:
                out.setdefault((c.cpp.file, c.cpp.symbol), []).append(c)
        for rows in out.values():
            rows.sort(key=lambda c: c.cpp.index if c.cpp else 0)
        return out

    def cpp_literals(self) -> List[Contract]:
        """Contracts pinned to a single-literal C++ accessor."""
        return [c for c in self.contracts
                if c.cpp is not None and c.cpp.index < 0
                and not c.cpp.key and not c.cpp.case]

    def cpp_map_entries(self) -> List[Contract]:
        """Contracts pinned to one entry of a C++ string map."""
        return [c for c in self.contracts
                if c.cpp is not None and c.cpp.key]

    def cpp_case_sets(self) -> Dict[Tuple[str, str], List[Contract]]:
        """{(cpp file, symbol): contracts} for every switch-case set."""
        out: Dict[Tuple[str, str], List[Contract]] = {}
        for c in self.contracts:
            if c.cpp is not None and c.cpp.case:
                out.setdefault((c.cpp.file, c.cpp.symbol), []).append(c)
        return out

    def to_json(self) -> Dict[str, object]:
        return {"version": 1,
                "contracts": [c.to_dict() for c in self.contracts]}


def _rel(module: object) -> str:
    """Repo-relative source path of a tpu_cluster_torch module."""
    path = getattr(module, "__file__", None)
    assert isinstance(path, str)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.relpath(os.path.abspath(path), pkg_root)


_OPERATOR_SOURCES: Tuple[str, ...] = (
    "native/operator/operator_main.cc", "native/operator/selftest.cc")
_KUBEAPI_CC = "native/operator/kubeapi.cc"
_KUBECLIENT_CC = "native/operator/kubeclient.cc"

# Docs: names shared with the reference stay in its guide; the GPU's
# names are documented in the README's contract table.
_GUIDE = ("docs/GUIDE.md",)
_README = ("README.md",)

# Kinds the CLI addresses by plural that the native operator never does
# (it applies the bundle's operands, not Nodes, the CRD or its own
# policy object), so its Plurals() map has no entry for them.
_CLI_ONLY_KINDS = frozenset({"Node", "CustomResourceDefinition",
                             "TpuStackPolicy"})

# EventRecorder components the port's controllers post under (the
# Event's ``source.component``, which runbooks filter on). Literals at
# their call sites in __main__.py; pinlint harvests every
# ``component="..."`` keyword literal and checks it is declared here.
EVENT_COMPONENTS: Tuple[str, ...] = (
    "tpuctl", "gpu-admission", "gpu-maintenance", "gpu-autoscale")


def build_registry() -> Registry:
    """Assemble the registry from the LIVE module constants (imports are
    local so the registry can be built without dragging the whole
    package in at import time)."""
    from tpu_cluster_torch.render import operator_bundle
    from tpu_cluster_torch import admission, autoscale, events, \
        kubeapply, lint, maintenance, spec, telemetry, verify
    from tpu_cluster_torch.discovery import labels as dlabels
    from tpu_cluster_torch.workloads import runtime_metrics, serving

    out: List[Contract] = []
    tele_f = _rel(telemetry)
    adm_f = _rel(admission)
    maint_f = _rel(maintenance)
    auto_f = _rel(autoscale)
    rtm_f = _rel(runtime_metrics)
    kube_f = _rel(kubeapply)

    # ---- metric families: the C++ operator's twin table (ordered) ----
    for i, fam in enumerate(telemetry.OPERATOR_METRIC_NAMES):
        out.append(Contract(
            name=f"metric/{fam}", kind=KIND_METRIC_FAMILY, value=fam,
            py_file=tele_f, py_attr=f"OPERATOR_METRIC_NAMES[{i}]",
            cpp=CppPin(_KUBEAPI_CC, "OperatorMetricNames", index=i),
            enforcers=_OPERATOR_SOURCES, docs=_GUIDE))

    # ---- metric families: the Python client/controller constants ----
    # (every module-level UPPER_CASE str in telemetry.py whose value is
    # family-shaped; harvesting from the module keeps a new constant
    # registered the moment it is declared there)
    for attr in sorted(vars(telemetry)):
        if not attr.isupper() or attr.startswith("_"):
            continue
        val = getattr(telemetry, attr)
        if not isinstance(val, str):
            continue
        if attr in ("TRACEPARENT_ANNOTATION",):
            continue  # registered below with its C++ pin
        if not re.fullmatch(r"[a-z_:][a-z0-9_:]*", val):
            continue  # not family-shaped (Prometheus name grammar)
        out.append(Contract(
            name=f"metric/{val}", kind=KIND_METRIC_FAMILY, value=val,
            py_file=tele_f, py_attr=attr, docs=_GUIDE))

    # ---- metric families: the runtime-metrics file exporter ---------
    for attr in ("DUTY_CYCLE_PERCENT", "TENSORCORE_UTILIZATION_PERCENT"):
        val = getattr(runtime_metrics, attr)
        assert isinstance(val, str)
        out.append(Contract(
            name=f"metric/{val}", kind=KIND_METRIC_FAMILY, value=val,
            py_file=rtm_f, py_attr=attr,
            docs=_GUIDE + ("docs/TESTING.md",)))

    # the HBM gauge the runtime-metrics writer renders inline (and the
    # port's verify reads back through the relay)
    out.append(Contract(
        name="metric/tpu_hbm_used_bytes", kind=KIND_METRIC_FAMILY,
        value=verify.WORKLOAD_GAUGES[1], py_file=_rel(verify),
        py_attr="WORKLOAD_GAUGES[1]", enforcers=(rtm_f,), docs=_README))

    # ---- trace slices -----------------------------------------------
    for i, slice_name in enumerate(telemetry.OPERATOR_TRACE_EVENTS):
        out.append(Contract(
            name=f"trace/{slice_name}", kind=KIND_TRACE_SLICE,
            value=slice_name, py_file=tele_f,
            py_attr=f"OPERATOR_TRACE_EVENTS[{i}]",
            cpp=CppPin(_KUBEAPI_CC, "OperatorTraceEventNames", index=i),
            enforcers=_OPERATOR_SOURCES, docs=_GUIDE))

    # ---- annotations / labels ---------------------------------------
    out.append(Contract(
        name="annotation/traceparent", kind=KIND_ANNOTATION,
        value=telemetry.TRACEPARENT_ANNOTATION, py_file=tele_f,
        py_attr="TRACEPARENT_ANNOTATION",
        cpp=CppPin(_KUBEAPI_CC, "TraceparentAnnotation"),
        enforcers=("native/operator/selftest.cc",), docs=_GUIDE))
    # no C++ pin: the native plugin that reads it does not run on GPU
    # hosts; admission writes it (gang_annotations) and reads it back
    out.append(Contract(
        name="annotation/gang", kind=KIND_ANNOTATION,
        value=admission.GANG_ANNOTATION, py_file=adm_f,
        py_attr="GANG_ANNOTATION", enforcers=(adm_f,), docs=_GUIDE))
    for attr in ("GANG_ACCELERATOR_ANNOTATION", "GANG_PRIORITY_ANNOTATION",
                 "GANG_STATUS_ANNOTATION", "GANG_REASON_ANNOTATION",
                 "MAINTENANCE_ANNOTATION"):
        out.append(Contract(
            name=f"annotation/{getattr(admission, attr)}",
            kind=KIND_ANNOTATION, value=getattr(admission, attr),
            py_file=adm_f, py_attr=attr, docs=_GUIDE))
    out.append(Contract(
        name="annotation/lint-allow", kind=KIND_ANNOTATION,
        value=lint.LINT_ALLOW_ANNOTATION, py_file=_rel(lint),
        py_attr="LINT_ALLOW_ANNOTATION", docs=_GUIDE))
    out.append(Contract(
        name="label/stack-version", kind=KIND_LABEL,
        value=maintenance.VERSION_LABEL, py_file=maint_f,
        py_attr="VERSION_LABEL",
        enforcers=(FAKE_APISERVER_PATH,), docs=_GUIDE))
    # feature-discovery labels: written by the port's labels module
    # (compute_labels, which the labeler publishes), not by a native TFD
    for attr in ("PRESENT", "PRODUCT", "FAMILY", "TOPOLOGY", "COUNT",
                 "NVLINK_DOMAIN"):
        out.append(Contract(
            name=f"label/{getattr(dlabels, attr)}", kind=KIND_LABEL,
            value=getattr(dlabels, attr), py_file=_rel(dlabels),
            py_attr=attr, enforcers=(_rel(dlabels),), docs=_README))
    out.append(Contract(
        name="resource/gpu", kind=KIND_RESOURCE,
        value=spec.DEFAULT_RESOURCE, py_file=_rel(spec),
        py_attr="DEFAULT_RESOURCE", docs=_README))

    # ---- event reasons and components --------------------------------
    for module, mod_file in ((admission, adm_f), (maintenance, maint_f),
                             (autoscale, auto_f)):
        for attr in sorted(vars(module)):
            if attr.startswith("EVENT_"):
                val = getattr(module, attr)
                assert isinstance(val, str)
                out.append(Contract(
                    name=f"event-reason/{val}", kind=KIND_EVENT_REASON,
                    value=val, py_file=mod_file, py_attr=attr,
                    docs=_GUIDE))
    for attr in ("EVENT_TYPE_NORMAL", "EVENT_TYPE_WARNING"):
        out.append(Contract(
            name=f"event-type/{getattr(events, attr)}",
            kind=KIND_EVENT_TYPE, value=getattr(events, attr),
            py_file=_rel(events), py_attr=attr, docs=_GUIDE))
    for i, component in enumerate(EVENT_COMPONENTS):
        out.append(Contract(
            name=f"event-component/{component}",
            kind=KIND_EVENT_COMPONENT, value=component,
            py_file="tpu_cluster_torch/contracts.py",
            py_attr=f"EVENT_COMPONENTS[{i}]",
            enforcers=("tpu_cluster_torch/__main__.py",), docs=_README))

    # ---- ConfigMaps and their keys / schema versions ----------------
    # (the reservation table carries no C++ pin: NVIDIA's device plugin
    # does not read it, and the native tpud does not run on GPU hosts)
    out.append(Contract(
        name="configmap/gpu-gang-reservations", kind=KIND_CONFIGMAP,
        value=admission.RESERVATION_CONFIGMAP, py_file=adm_f,
        py_attr="RESERVATION_CONFIGMAP", enforcers=(adm_f,),
        docs=_README))
    out.append(Contract(
        name="configmap-key/reservations.json", kind=KIND_CONFIGMAP_KEY,
        value=admission.RESERVATION_KEY, py_file=adm_f,
        py_attr="RESERVATION_KEY", enforcers=(adm_f,), docs=_GUIDE))
    out.append(Contract(
        name="schema-version/reservations", kind=KIND_SCHEMA_VERSION,
        value=str(admission.RESERVATION_SCHEMA_VERSION), py_file=adm_f,
        py_attr="RESERVATION_SCHEMA_VERSION"))
    out.append(Contract(
        name="configmap/gpu-maintenance-state", kind=KIND_CONFIGMAP,
        value=maintenance.MAINTENANCE_CONFIGMAP, py_file=maint_f,
        py_attr="MAINTENANCE_CONFIGMAP", docs=_README))
    out.append(Contract(
        name="configmap-key/state.json", kind=KIND_CONFIGMAP_KEY,
        value=maintenance.MAINTENANCE_KEY, py_file=maint_f,
        py_attr="MAINTENANCE_KEY"))
    out.append(Contract(
        name="schema-version/maintenance", kind=KIND_SCHEMA_VERSION,
        value=str(maintenance.MAINTENANCE_SCHEMA_VERSION),
        py_file=maint_f, py_attr="MAINTENANCE_SCHEMA_VERSION"))
    out.append(Contract(
        name="configmap/gpu-autoscale-state", kind=KIND_CONFIGMAP,
        value=autoscale.AUTOSCALE_CONFIGMAP, py_file=auto_f,
        py_attr="AUTOSCALE_CONFIGMAP", docs=_README))
    out.append(Contract(
        name="configmap-key/autoscale.json", kind=KIND_CONFIGMAP_KEY,
        value=autoscale.AUTOSCALE_KEY, py_file=auto_f,
        py_attr="AUTOSCALE_KEY"))
    out.append(Contract(
        name="schema-version/autoscale", kind=KIND_SCHEMA_VERSION,
        value=str(autoscale.AUTOSCALE_SCHEMA_VERSION),
        py_file=auto_f, py_attr="AUTOSCALE_SCHEMA_VERSION"))
    out.append(Contract(
        name="annotation/serving-replica", kind=KIND_ANNOTATION,
        value=autoscale.SERVING_REPLICA_ANNOTATION, py_file=auto_f,
        py_attr="SERVING_REPLICA_ANNOTATION", docs=_GUIDE))
    out.append(Contract(
        name="configmap/gpu-operator-bundle", kind=KIND_CONFIGMAP,
        value=operator_bundle.BUNDLE_CONFIGMAP,
        py_file=_rel(operator_bundle), py_attr="BUNDLE_CONFIGMAP",
        enforcers=(
            "deploy/chart/gpu-stack/templates/50-operator.yaml",),
        docs=_README))

    # ---- field managers ---------------------------------------------
    out.append(Contract(
        name="field-manager/tpuctl", kind=KIND_FIELD_MANAGER,
        value=kubeapply.FIELD_MANAGER, py_file=kube_f,
        py_attr="FIELD_MANAGER", docs=_GUIDE))
    out.append(Contract(
        name="field-manager/tpu-operator", kind=KIND_FIELD_MANAGER,
        value=kubeapply.OPERATOR_FIELD_MANAGER, py_file=kube_f,
        py_attr="OPERATOR_FIELD_MANAGER",
        cpp=CppPin(_KUBEAPI_CC, "FieldManager"),
        enforcers=("native/operator/selftest.cc",), docs=_GUIDE))

    # ---- the native operator's kind tables and retry taxonomy -------
    # (the port's client and linter keep twins of these; the operator
    # the GPU stack deploys reads the C++ side)
    for kind in sorted(kubeapply._KINDS):
        if kind in _CLI_ONLY_KINDS:
            continue
        plural = kubeapply._KINDS[kind][0]
        out.append(Contract(
            name=f"plural/{kind}", kind=KIND_PLURAL, value=plural,
            py_file=kube_f, py_attr="_KINDS",
            cpp=CppPin(_KUBEAPI_CC, "Plurals", key=kind)))
    for status in sorted(kubeapply.RETRYABLE_STATUSES):
        out.append(Contract(
            name=f"retryable-status/{status}",
            kind=KIND_RETRYABLE_STATUS, value=str(status),
            py_file=kube_f, py_attr="RETRYABLE_STATUSES",
            cpp=CppPin(_KUBECLIENT_CC, "RetryableStatus", case=True),
            enforcers=("native/operator/selftest.cc",)))
    for i, (_group, kind) in enumerate(lint.OPERAND_WORKLOAD_KINDS):
        out.append(Contract(
            name=f"workload-kind/{kind}", kind=KIND_WORKLOAD_KIND,
            value=kind, py_file=_rel(lint),
            py_attr=f"OPERAND_WORKLOAD_KINDS[{i}]",
            cpp=CppPin(_KUBEAPI_CC, "OperandWorkloadKinds", index=i),
            enforcers=("native/operator/operator_main.cc",)))

    # ---- gang statuses / maintenance phases -------------------------
    for attr in ("STATUS_ADMITTED", "STATUS_QUEUED", "STATUS_PREEMPTED"):
        out.append(Contract(
            name=f"status/{getattr(admission, attr)}", kind=KIND_STATUS,
            value=getattr(admission, attr), py_file=adm_f, py_attr=attr,
            docs=_GUIDE))
    # serving terminal statuses: the frontend's HTTP response-body
    # vocabulary ("status" in the /v1/generate JSON) that the load
    # generator's sender parses back out — cross-process over the wire
    serv_f = _rel(serving)
    for attr in ("STATUS_OK", "STATUS_DEADLINE", "STATUS_REJECTED"):
        out.append(Contract(
            name=f"status/serving/{getattr(serving, attr)}",
            kind=KIND_STATUS, value=getattr(serving, attr),
            py_file=serv_f, py_attr=attr, docs=_GUIDE))
    for i, phase in enumerate(maintenance.PHASES):
        out.append(Contract(
            name=f"phase/{phase}", kind=KIND_PHASE, value=phase,
            py_file=maint_f, py_attr=f"PHASES[{i}]", docs=_GUIDE))
    # rollout phases (`top` timings order; a distinct vocabulary from
    # the maintenance wave phases above)
    for i, phase in enumerate(telemetry.PHASE_NAMES):
        out.append(Contract(
            name=f"phase/rollout/{phase}", kind=KIND_PHASE, value=phase,
            py_file=tele_f, py_attr=f"PHASE_NAMES[{i}]",
            docs=_GUIDE))

    # ---- chaos kinds ------------------------------------------------
    for kind_name in CHAOS_KINDS:
        out.append(Contract(
            name=f"chaos/{kind_name}", kind=KIND_CHAOS_KIND,
            value=kind_name, py_file="tpu_cluster_torch/contracts.py",
            py_attr="CHAOS_KINDS",
            enforcers=(FAKE_APISERVER_PATH,), docs=("docs/TESTING.md",)))

    return Registry(out)
