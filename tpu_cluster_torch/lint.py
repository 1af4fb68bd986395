"""Static cross-object analysis of a rendered manifest bundle: the
counterpart of ``tpu_cluster/lint.py``, with the same rules, rule IDs,
severities and JSON-path loci.

Schema tools and per-object linters see one document at a time. This
module checks the cross-object invariants they cannot: dangling
intra-bundle references, selector integrity, and apply-order violations
against the dependency tiers an apply executes (Namespace/CRD ->
RBAC/config -> workloads inside a group, groups in order). The linter and
the apply engine share ``kubeapply._TIER_FIRST``/``WORKLOAD_KINDS``, so
they cannot disagree about what "before" means.

Input shape is ``Sequence[Sequence[dict]]``, the group-of-groups form
(``manifests.rollout_groups``, ``operator_bundle.operator_install_groups``).
Output is a list of structured :class:`Finding` records (rule id,
severity, object identity, JSON-path locus, message, fix hint).

Rules:

  R01  duplicate GVK+namespace+name across the bundle's groups
  R02  dangling intra-bundle references: workload -> ServiceAccount,
       ConfigMap/Secret volume + envFrom/env refs, RoleBinding/
       ClusterRoleBinding -> Role/ClusterRole + subject ServiceAccounts,
       Service -> selector-matching workload. Refs expected to pre-exist
       on-cluster are allowlisted (``external``); the default allowlist
       covers the ``default`` ServiceAccount every namespace ships.
  R03  selector integrity: a workload's spec.selector must match its own
       pod-template labels; version-shaped selector keys draw an
       immutable-selector warning (apps/v1 selectors cannot be edited).
  R04  ordering/tiering: a CR must land in a group strictly after its
       CRD's (establishment is gated at the group boundary); a namespaced
       object must not precede its Namespace; an object must not be
       tiered after something that references it.
  R05  GPU resource sanity: ``nvidia.com/gpu`` request==limit, a whole
       number, and between 1 and the host layout's cards; privileged/
       hostPath/hostNetwork on non-operand workloads is audited (warn).
  R06  image pins (no ``:latest``/untagged) and probe/port cross-check
       (a probe's named port must exist in containerPorts; a numeric
       probe port should be declared).
  R07  gang shape: a multi-worker GPU Job needs parallelism ==
       completions, Indexed completion mode, and a whole host's cards a
       worker, or its workers can never all seat. A GPU host layout
       tiles no multi-host slice, so the reference's slice-tiling check
       has no counterpart here.

Surfaces: ``python -m tpu_cluster_torch lint`` and the pre-apply gate
:func:`gate`. Nothing here imports PyYAML.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Collection, Dict, FrozenSet, List,
                    Optional, Sequence, Set, Tuple)

from .kubeapply import _KINDS, _TIER_FIRST, WORKLOAD_KINDS, ApplyError
from .spec import ClusterSpec

Manifest = Dict[str, Any]

SEV_ERROR = "error"
SEV_WARN = "warn"

# GVKs the linter treats as *operand workloads*: the kinds whose
# privileged/hostPath/hostNetwork use is expected (host-prep and device
# plugins need the host), so the R05 security audit skips them. This is
# the Python twin of the C++ operator's owned-collection list
# (kubeapi::OperandWorkloadKinds — the drift-watch targets): both name
# exactly the kinds an operand bundle deploys as workloads, and
# tests/test_torch_lint.py pins the two tables to each other.
OPERAND_WORKLOAD_KINDS: Tuple[Tuple[str, str], ...] = (
    ("apps/v1", "DaemonSet"),
    ("apps/v1", "Deployment"),
)

# Kinds that carry a pod template at .spec.template.spec.
POD_TEMPLATE_KINDS: Tuple[str, ...] = ("DaemonSet", "Deployment",
                                       "StatefulSet", "Job")

# apiVersions the apiserver serves without any CRD — an object outside
# these groups is a custom resource and needs its CRD earlier in the
# bundle (or an explicit external allowlist entry).
BUILTIN_API_VERSIONS: FrozenSet[str] = frozenset({
    "v1", "apps/v1", "batch/v1", "rbac.authorization.k8s.io/v1",
    "apiextensions.k8s.io/v1", "coordination.k8s.io/v1",
    "scheduling.k8s.io/v1", "policy/v1", "networking.k8s.io/v1",
})

# Selector keys that version/release tooling rewrites per deploy. apps/v1
# selectors are immutable, so a selector carrying one of these breaks the
# first upgrade with "field is immutable" — warn at render time instead.
VERSIONISH_SELECTOR_KEYS: Tuple[str, ...] = (
    "app.kubernetes.io/version", "version", "release", "chart",
    "helm.sh/chart",
)

# References expected to pre-exist on any cluster. Entries are
# "Kind/name" (cluster-scoped), "Kind/namespace/name", with "*" wildcards
# allowed for namespace and name ("Kind/*" allows every object of a
# kind — e.g. a CR whose CRD another install owns).
DEFAULT_EXTERNAL: FrozenSet[str] = frozenset({
    "ServiceAccount/*/default",
})

GPU_RESOURCE_DEFAULT = "nvidia.com/gpu"

# An object can acknowledge an intentional WARN-severity audit finding
# with this annotation (comma-separated tokens: "hostPath", "privileged",
# "hostNetwork", "probe-port"). The acknowledgement is scoped — each
# token waives exactly one check on exactly that object — and
# error-severity findings can never be waived: those are apiserver
# rejections, not judgment calls.
LINT_ALLOW_ANNOTATION = "tpu-stack.dev/lint-allow"


def _allows(obj: Manifest) -> FrozenSet[str]:
    anns = (obj.get("metadata") or {}).get("annotations") or {}
    raw = str(anns.get(LINT_ALLOW_ANNOTATION, ""))
    return frozenset(t.strip() for t in raw.split(",") if t.strip())


@dataclass(frozen=True)
class Finding:
    """One lint result: rule id, severity, the object it is about, a
    JSON-path locus inside that object, a human message, and a fix hint."""

    rule: str       # "R01".."R07"
    severity: str   # SEV_ERROR | SEV_WARN
    kind: str
    namespace: str  # "" for cluster-scoped objects
    name: str
    path: str       # JSON-path locus, e.g. ".spec.template.spec.containers[0].image"
    message: str
    hint: str = ""

    def ident(self) -> str:
        if self.namespace:
            return f"{self.kind}/{self.namespace}/{self.name}"
        return f"{self.kind}/{self.name}"

    def line(self) -> str:
        hint = f" (fix: {self.hint})" if self.hint else ""
        return (f"{self.rule} {self.severity:5s} {self.ident()} "
                f"{self.path}: {self.message}{hint}")

    def to_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "severity": self.severity,
                "kind": self.kind, "namespace": self.namespace,
                "name": self.name, "path": self.path,
                "message": self.message, "hint": self.hint}


class LintGateError(ApplyError):
    """Raised by :func:`gate` in ``--lint=error`` mode BEFORE the rollout
    issues its first request (an ApplyError so every apply caller's
    existing error handling reports it)."""


# --------------------------------------------------------------------------
# bundle indexing


def _tier_index(obj: Manifest) -> int:
    """The object's dependency tier — the SAME classification
    ``kubeapply._group_tiers`` applies inside a group (Namespace/CRD ->
    RBAC/config -> workloads)."""
    kind = str(obj.get("kind", ""))
    if kind in _TIER_FIRST:
        return 0
    if kind in WORKLOAD_KINDS:
        return 2
    return 1


@dataclass(frozen=True)
class _Loc:
    """Where one object sits in the bundle: group index, position inside
    the group, and its apply tier within that group."""

    group: int
    index: int
    tier: int

    def before(self, other: "_Loc") -> bool:
        """True when this location is applied strictly before ``other``
        under BOTH engines: an earlier group always is; inside one group
        the sequential engine uses list order and the pipelined engine
        uses tier barriers, so 'before' requires both not-later."""
        if self.group != other.group:
            return self.group < other.group
        return self.tier <= other.tier and self.index < other.index


class _Bundle:
    """Index over the grouped objects: identity -> locations (R01 needs
    the multiplicity), CRD-defined kinds, and namespace-scope answers."""

    def __init__(self, groups: Sequence[Sequence[Manifest]]):
        self.groups: List[List[Manifest]] = [list(g) for g in groups]
        self.entries: List[Tuple[_Loc, Manifest]] = []
        # (kind, namespace, name) -> locations; namespace "" when
        # cluster-scoped
        self.by_id: Dict[Tuple[str, str, str], List[_Loc]] = {}
        # (apiGroup, kind) -> CRD location + scope, from in-bundle CRDs
        self.crds: Dict[Tuple[str, str], Tuple[_Loc, str]] = {}
        for gi, group in enumerate(self.groups):
            for li, obj in enumerate(group):
                loc = _Loc(gi, li, _tier_index(obj))
                self.entries.append((loc, obj))
                if obj.get("kind") == "CustomResourceDefinition":
                    spec = obj.get("spec") or {}
                    names = spec.get("names") or {}
                    key = (str(spec.get("group", "")),
                           str(names.get("kind", "")))
                    self.crds[key] = (loc, str(spec.get("scope", "")))
        # second pass: identity needs the CRD scope table complete
        for loc, obj in self.entries:
            self.by_id.setdefault(self.ident(obj), []).append(loc)

    def is_cluster_scoped(self, obj: Manifest) -> bool:
        kind = str(obj.get("kind", ""))
        if kind in _KINDS and kind != "TpuStackPolicy":
            scoped: bool = _KINDS[kind][1]
            return scoped
        group = str(obj.get("apiVersion", "")).split("/")[0]
        crd = self.crds.get((group, kind))
        if crd is not None:
            return crd[1] == "Cluster"
        if kind == "TpuStackPolicy":  # CR known to kubeapply's table
            return True
        # unknown kind: namespace presence is the only signal left
        return "namespace" not in (obj.get("metadata") or {})

    def namespace_of(self, obj: Manifest) -> str:
        if self.is_cluster_scoped(obj):
            return ""
        ns = (obj.get("metadata") or {}).get("namespace")
        # an apply defaults a missing namespace the same way
        return str(ns) if ns else "default"

    def ident(self, obj: Manifest) -> Tuple[str, str, str]:
        meta = obj.get("metadata") or {}
        return (str(obj.get("kind", "")), self.namespace_of(obj),
                str(meta.get("name", "")))

    def lookup(self, kind: str, namespace: str,
               name: str) -> Optional[_Loc]:
        locs = self.by_id.get((kind, namespace, name))
        return locs[0] if locs else None

    def workloads(self) -> List[Tuple[_Loc, Manifest]]:
        return [(loc, obj) for loc, obj in self.entries
                if obj.get("kind") in POD_TEMPLATE_KINDS]


def _is_external(kind: str, namespace: str, name: str,
                 external: Collection[str]) -> bool:
    """Does the allowlist cover this reference? Accepted entry shapes:
    "Kind/name" (cluster-scoped), "Kind/namespace/name", with "*"
    wildcarding the namespace and/or name, and "Kind/*" for every object
    of a kind."""
    candidates = {f"{kind}/{name}", f"{kind}/*",
                  f"{kind}/{namespace}/{name}", f"{kind}/{namespace}/*",
                  f"{kind}/*/{name}", f"{kind}/*/*"}
    return bool(candidates & set(external))


def _finding(bundle: _Bundle, obj: Manifest, rule: str, severity: str,
             path: str, message: str, hint: str = "") -> Finding:
    kind, ns, name = bundle.ident(obj)
    return Finding(rule=rule, severity=severity, kind=kind, namespace=ns,
                   name=name, path=path, message=message, hint=hint)


def _pod_spec(obj: Manifest) -> Dict[str, Any]:
    tmpl = ((obj.get("spec") or {}).get("template") or {})
    spec = tmpl.get("spec") or {}
    return spec if isinstance(spec, dict) else {}


def _template_labels(obj: Manifest) -> Dict[str, str]:
    tmpl = ((obj.get("spec") or {}).get("template") or {})
    labels = (tmpl.get("metadata") or {}).get("labels") or {}
    return {str(k): str(v) for k, v in labels.items()} \
        if isinstance(labels, dict) else {}


def _containers(pod: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """(json-path, container) for every container incl. initContainers."""
    out: List[Tuple[str, Dict[str, Any]]] = []
    for field_name in ("initContainers", "containers"):
        for i, c in enumerate(pod.get(field_name) or []):
            if isinstance(c, dict):
                out.append((f"{field_name}[{i}]", c))
    return out


# --------------------------------------------------------------------------
# R01 — duplicates


def _r01_duplicates(bundle: _Bundle) -> List[Finding]:
    findings: List[Finding] = []
    seen: Dict[Tuple[str, str, str, str], _Loc] = {}
    for loc, obj in bundle.entries:
        kind, ns, name = bundle.ident(obj)
        key = (str(obj.get("apiVersion", "")), kind, ns, name)
        first = seen.get(key)
        if first is None:
            seen[key] = loc
            continue
        findings.append(_finding(
            bundle, obj, "R01", SEV_ERROR, ".metadata.name",
            f"duplicate object: also rendered in group {first.group} "
            f"(this copy is in group {loc.group}); the later apply "
            "silently overwrites the earlier one",
            "render each GVK+namespace+name exactly once"))
    return findings


# --------------------------------------------------------------------------
# R02 — dangling references


@dataclass(frozen=True)
class _Ref:
    """One intra-bundle reference edge, used by R02 (existence) and R04
    (ordering): ``obj``'s field at ``path`` names (kind, namespace, name)."""

    kind: str
    namespace: str
    name: str
    path: str
    reason: str


def _workload_refs(bundle: _Bundle, obj: Manifest) -> List[_Ref]:
    ns = bundle.namespace_of(obj)
    pod = _pod_spec(obj)
    base = ".spec.template.spec"
    refs: List[_Ref] = []
    sa = pod.get("serviceAccountName")
    if sa:
        refs.append(_Ref("ServiceAccount", ns, str(sa),
                         f"{base}.serviceAccountName",
                         "pod serviceAccountName"))
    for vi, vol in enumerate(pod.get("volumes") or []):
        if not isinstance(vol, dict):
            continue
        cm = vol.get("configMap") or {}
        if cm.get("name") and not cm.get("optional"):
            refs.append(_Ref("ConfigMap", ns, str(cm["name"]),
                             f"{base}.volumes[{vi}].configMap.name",
                             "volume configMap"))
        sec = vol.get("secret") or {}
        if sec.get("secretName") and not sec.get("optional"):
            refs.append(_Ref("Secret", ns, str(sec["secretName"]),
                             f"{base}.volumes[{vi}].secret.secretName",
                             "volume secret"))
    for cpath, c in _containers(pod):
        for ei, envfrom in enumerate(c.get("envFrom") or []):
            if not isinstance(envfrom, dict):
                continue
            for src_field, kind in (("configMapRef", "ConfigMap"),
                                    ("secretRef", "Secret")):
                src = envfrom.get(src_field) or {}
                if src.get("name") and not src.get("optional"):
                    refs.append(_Ref(
                        kind, ns, str(src["name"]),
                        f"{base}.{cpath}.envFrom[{ei}].{src_field}.name",
                        "envFrom"))
        for vi, env in enumerate(c.get("env") or []):
            if not isinstance(env, dict):
                continue
            vf = env.get("valueFrom") or {}
            for src_field, kind in (("configMapKeyRef", "ConfigMap"),
                                    ("secretKeyRef", "Secret")):
                src = vf.get(src_field) or {}
                if src.get("name") and not src.get("optional"):
                    refs.append(_Ref(
                        kind, ns, str(src["name"]),
                        f"{base}.{cpath}.env[{vi}].valueFrom"
                        f".{src_field}.name",
                        "env valueFrom"))
    return refs


def _binding_refs(bundle: _Bundle, obj: Manifest) -> List[_Ref]:
    kind = str(obj.get("kind", ""))
    ns = bundle.namespace_of(obj)
    refs: List[_Ref] = []
    role_ref = obj.get("roleRef") or {}
    rr_kind = str(role_ref.get("kind", ""))
    if rr_kind in ("Role", "ClusterRole") and role_ref.get("name"):
        # a RoleBinding may bind either a namespaced Role or a ClusterRole
        rr_ns = ns if rr_kind == "Role" else ""
        refs.append(_Ref(rr_kind, rr_ns, str(role_ref["name"]),
                         ".roleRef.name", f"{kind} roleRef"))
    for si, subject in enumerate(obj.get("subjects") or []):
        if not isinstance(subject, dict):
            continue
        if subject.get("kind") == "ServiceAccount" and subject.get("name"):
            refs.append(_Ref(
                "ServiceAccount", str(subject.get("namespace", "default")),
                str(subject["name"]), f".subjects[{si}].name",
                f"{kind} subject"))
    return refs


def bundle_refs(bundle: _Bundle) -> List[Tuple[_Loc, Manifest, _Ref]]:
    """Every reference edge the linter understands, with the referring
    object's location — shared by R02 (does the target exist?) and R04
    (is the target ordered before its referrer?)."""
    edges: List[Tuple[_Loc, Manifest, _Ref]] = []
    for loc, obj in bundle.entries:
        kind = obj.get("kind")
        if kind in POD_TEMPLATE_KINDS:
            for ref in _workload_refs(bundle, obj):
                edges.append((loc, obj, ref))
        elif kind in ("RoleBinding", "ClusterRoleBinding"):
            for ref in _binding_refs(bundle, obj):
                edges.append((loc, obj, ref))
    return edges


def _r02_references(bundle: _Bundle,
                    external: Collection[str]) -> List[Finding]:
    findings: List[Finding] = []
    for _loc, obj, ref in bundle_refs(bundle):
        if bundle.lookup(ref.kind, ref.namespace, ref.name) is not None:
            continue
        if _is_external(ref.kind, ref.namespace, ref.name, external):
            continue
        target = (f"{ref.kind}/{ref.namespace}/{ref.name}"
                  if ref.namespace else f"{ref.kind}/{ref.name}")
        findings.append(_finding(
            bundle, obj, "R02", SEV_ERROR, ref.path,
            f"{ref.reason} names {target}, which is not in the bundle",
            "render the missing object, or allowlist it with "
            f"--allow-external {target} if it pre-exists on-cluster"))
    findings.extend(_r02_services(bundle))
    return findings


def _selector_matches_workload(bundle: _Bundle, namespace: str,
                               selector: Dict[str, str]) -> bool:
    for _loc, obj in bundle.workloads():
        if bundle.namespace_of(obj) != namespace:
            continue
        labels = dict(_template_labels(obj))
        if obj.get("kind") == "Job":
            # the Job controller stamps job-name onto every pod it creates
            job = str((obj.get("metadata") or {}).get("name", ""))
            labels.setdefault("job-name", job)
            labels.setdefault("batch.kubernetes.io/job-name", job)
        if all(labels.get(k) == v for k, v in selector.items()):
            return True
    return False


def _r02_services(bundle: _Bundle) -> List[Finding]:
    findings: List[Finding] = []
    for _loc, obj in bundle.entries:
        if obj.get("kind") != "Service":
            continue
        spec = obj.get("spec") or {}
        if spec.get("type") == "ExternalName":
            continue
        selector = spec.get("selector") or {}
        if not selector:  # selector-less Services (manual Endpoints) are legal
            continue
        sel = {str(k): str(v) for k, v in selector.items()}
        if _selector_matches_workload(bundle, bundle.namespace_of(obj), sel):
            continue
        findings.append(_finding(
            bundle, obj, "R02", SEV_ERROR, ".spec.selector",
            "selector "
            + ",".join(f"{k}={v}" for k, v in sorted(sel.items()))
            + " matches no workload pod template in the bundle "
            "(the Service would have zero endpoints)",
            "align the selector with the target workload's "
            ".spec.template.metadata.labels"))
    return findings


# --------------------------------------------------------------------------
# R03 — selector integrity


def _r03_selectors(bundle: _Bundle) -> List[Finding]:
    findings: List[Finding] = []
    for _loc, obj in bundle.entries:
        kind = obj.get("kind")
        if kind not in POD_TEMPLATE_KINDS:
            continue
        spec = obj.get("spec") or {}
        selector = spec.get("selector") or {}
        match = selector.get("matchLabels") or {}
        if kind == "Job":
            if selector and not spec.get("manualSelector"):
                findings.append(_finding(
                    bundle, obj, "R03", SEV_ERROR, ".spec.selector",
                    "Job sets spec.selector without manualSelector: the "
                    "apiserver rejects a non-generated Job selector",
                    "drop the selector; the Job controller generates one"))
            continue
        if not match:
            if selector.get("matchExpressions"):
                # legal apps/v1 shape we cannot statically evaluate —
                # not a finding (the gate must never block a bundle the
                # apiserver would accept)
                continue
            findings.append(_finding(
                bundle, obj, "R03", SEV_ERROR, ".spec.selector",
                f"{kind} has no spec.selector (apps/v1 requires one, "
                "and it must match the template)",
                "set selector.matchLabels to the pod-template labels"))
            continue
        labels = _template_labels(obj)
        mismatched = {str(k): str(v) for k, v in match.items()
                      if labels.get(str(k)) != str(v)}
        if mismatched:
            findings.append(_finding(
                bundle, obj, "R03", SEV_ERROR,
                ".spec.selector.matchLabels",
                "selector does not match the pod-template labels "
                f"(unmatched: {sorted(mismatched)}); the apiserver "
                "rejects the object with 422",
                "make .spec.template.metadata.labels a superset of "
                "the selector"))
            continue
        versionish = sorted(str(k) for k in match
                            if str(k) in VERSIONISH_SELECTOR_KEYS)
        if versionish:
            findings.append(_finding(
                bundle, obj, "R03", SEV_WARN,
                ".spec.selector.matchLabels",
                f"selector carries version-shaped key(s) {versionish}; "
                "apps/v1 selectors are immutable, so the first upgrade "
                "that bumps the value fails with 'field is immutable'",
                "select on stable identity labels only "
                "(e.g. app.kubernetes.io/name)"))
    return findings


# --------------------------------------------------------------------------
# R04 — ordering / tiering


def _r04_ordering(bundle: _Bundle,
                  external: Collection[str]) -> List[Finding]:
    findings: List[Finding] = []
    # (a) custom resources vs their CRD: the apply backends gate CRD
    # establishment at the GROUP boundary, so a CR in the CRD's own group
    # (or earlier) races the establishment window -> apiserver 404.
    for loc, obj in bundle.entries:
        api_version = str(obj.get("apiVersion", ""))
        kind = str(obj.get("kind", ""))
        if (api_version in BUILTIN_API_VERSIONS
                or kind == "CustomResourceDefinition" or not kind):
            continue
        group = api_version.split("/")[0]
        crd = bundle.crds.get((group, kind))
        if crd is None:
            if _is_external(kind, bundle.namespace_of(obj),
                            str((obj.get("metadata") or {}).get("name", "")),
                            external):
                continue
            findings.append(_finding(
                bundle, obj, "R04", SEV_ERROR, ".apiVersion",
                f"custom resource {group}/{kind} has no CRD in the "
                "bundle; applying it fails with 'no matches for kind'",
                "render the CRD in an earlier group, or allowlist "
                f"--allow-external {kind}/* if another install owns it"))
            continue
        crd_loc, _scope = crd
        if crd_loc.group >= loc.group:
            findings.append(_finding(
                bundle, obj, "R04", SEV_ERROR, ".apiVersion",
                f"custom resource {group}/{kind} is applied in group "
                f"{loc.group} but its CRD is in group {crd_loc.group}; "
                "establishment is only gated at the group boundary, so "
                "this races the CRD's Established window",
                "move the CR to a group after its CRD's"))
    # (b) namespaced object before its Namespace (only when the Namespace
    # is itself part of the bundle — otherwise it is assumed pre-existing)
    for loc, obj in bundle.entries:
        ns = bundle.namespace_of(obj)
        if not ns or obj.get("kind") == "Namespace":
            continue
        ns_loc = bundle.lookup("Namespace", "", ns)
        if ns_loc is None or ns_loc.before(loc):
            continue
        findings.append(_finding(
            bundle, obj, "R04", SEV_ERROR, ".metadata.namespace",
            f"applied before its Namespace {ns!r} (namespace is at "
            f"group {ns_loc.group} index {ns_loc.index}, this object at "
            f"group {loc.group} index {loc.index}); a real apiserver "
            "rejects namespaced objects before their namespace exists",
            "order the Namespace first (earlier group, or earlier in "
            "the same group)"))
    # (c) reference targets tiered after their referrer: the readiness
    # gate of the referrer's group can wait forever on a pod that cannot
    # mount a ConfigMap/run under a ServiceAccount from a LATER group.
    for loc, obj, ref in bundle_refs(bundle):
        target = bundle.lookup(ref.kind, ref.namespace, ref.name)
        if target is None:  # R02's finding; don't double-report
            continue
        late = (target.group > loc.group
                or (target.group == loc.group and target.tier > loc.tier))
        if not late:
            continue
        findings.append(_finding(
            bundle, obj, "R04", SEV_ERROR, ref.path,
            f"references {ref.kind}/{ref.name} which is applied later "
            f"(target group {target.group} tier {target.tier}, referrer "
            f"group {loc.group} tier {loc.tier}); the group's readiness "
            "gate would wait on a dependency that does not exist yet",
            "move the referenced object to the same or an earlier "
            "group/tier"))
    return findings


# --------------------------------------------------------------------------
# R05 — GPU resource sanity + privilege audit


def _r05_gpu(bundle: _Bundle,
             spec: Optional[ClusterSpec]) -> List[Finding]:
    findings: List[Finding] = []
    resource = (spec.gpu.resource_name if spec is not None
                else GPU_RESOURCE_DEFAULT)
    host = spec.gpu.host_type if spec is not None else None
    for _loc, obj in bundle.workloads():
        pod = _pod_spec(obj)
        base = ".spec.template.spec"
        for cpath, c in _containers(pod):
            res = c.get("resources") or {}
            limits = res.get("limits") or {}
            requests = res.get("requests") or {}
            lim = limits.get(resource)
            req = requests.get(resource)
            if lim is None and req is None:
                continue
            rpath = f"{base}.{cpath}.resources"
            if lim is None:
                findings.append(_finding(
                    bundle, obj, "R05", SEV_ERROR, rpath,
                    f"{resource} requested without a limit; extended "
                    "resources require request==limit",
                    "set limits equal to requests"))
                continue
            if req is not None and str(req) != str(lim):
                findings.append(_finding(
                    bundle, obj, "R05", SEV_ERROR, rpath,
                    f"{resource} request ({req}) != limit ({lim}); the "
                    "apiserver rejects unequal extended-resource values",
                    "set request equal to limit"))
                continue
            try:
                count = int(str(lim))
            except ValueError:
                findings.append(_finding(
                    bundle, obj, "R05", SEV_ERROR, rpath,
                    f"{resource} count {lim!r} is not an integer",
                    "GPUs are counted whole"))
                continue
            if host is not None and not 1 <= count <= host.cards_per_host:
                findings.append(_finding(
                    bundle, obj, "R05", SEV_ERROR, rpath,
                    f"{resource}={count} is outside 1..{host.cards_per_host}"
                    f" for {host.name} ({host.label_topology()}); no node "
                    "of the layout can seat the pod",
                    f"request 1 to {host.cards_per_host}"))
    findings.extend(_r05_privilege_audit(bundle))
    return findings


# Labels that mark an object as part of the stack's operand set: the
# rendered operands carry app.kubernetes.io/part-of (render/manifests.py
# _meta) and bundle entries additionally carry the operand label
# (render/operator_bundle.py OPERAND_LABEL). The R05 audit exempts only
# workloads that are BOTH an operand GVK and identified as ours — kind
# alone must not grant host access.
_PART_OF_LABEL = "app.kubernetes.io/part-of"
_PART_OF_VALUE = "tpu-stack"
_OPERAND_LABEL = "tpu-stack.dev/operand"


def _is_operand_workload(obj: Manifest) -> bool:
    gvk = (str(obj.get("apiVersion", "")), str(obj.get("kind", "")))
    if gvk not in OPERAND_WORKLOAD_KINDS:
        return False
    labels = (obj.get("metadata") or {}).get("labels") or {}
    return (labels.get(_PART_OF_LABEL) == _PART_OF_VALUE
            or _OPERAND_LABEL in labels)


def _r05_privilege_audit(bundle: _Bundle) -> List[Finding]:
    """Host-level access on workloads that are NOT operands: operand
    DaemonSets/Deployments legitimately touch /dev and the kubelet socket
    (that is their job); anything else carrying host access deserves a
    second look before it ships. 'Operand' means an operand workload GVK
    (the drift-watch twin table) that also carries the stack's identity
    labels — an arbitrary privileged Deployment does not lint clean just
    because of its kind."""
    findings: List[Finding] = []
    for _loc, obj in bundle.workloads():
        if _is_operand_workload(obj):
            continue
        allows = _allows(obj)
        pod = _pod_spec(obj)
        base = ".spec.template.spec"
        if pod.get("hostNetwork") and "hostNetwork" not in allows:
            findings.append(_finding(
                bundle, obj, "R05", SEV_WARN, f"{base}.hostNetwork",
                "non-operand workload runs on the host network",
                "drop hostNetwork unless the pod genuinely needs it"))
        for vi, vol in enumerate(pod.get("volumes") or []):
            if (isinstance(vol, dict) and "hostPath" in vol
                    and "hostPath" not in allows):
                findings.append(_finding(
                    bundle, obj, "R05", SEV_WARN,
                    f"{base}.volumes[{vi}].hostPath",
                    "non-operand workload mounts a hostPath "
                    f"({(vol.get('hostPath') or {}).get('path', '?')})",
                    "prefer a ConfigMap/emptyDir, or document why the "
                    "host mount is required"))
        for cpath, c in _containers(pod):
            sc = c.get("securityContext") or {}
            if sc.get("privileged") and "privileged" not in allows:
                findings.append(_finding(
                    bundle, obj, "R05", SEV_WARN,
                    f"{base}.{cpath}.securityContext.privileged",
                    "non-operand workload runs privileged",
                    "scope down to the capabilities actually needed"))
    return findings


# --------------------------------------------------------------------------
# R06 — image pins + probe/port cross-check


def _image_finding(bundle: _Bundle, obj: Manifest, path: str,
                   image: str) -> Optional[Finding]:
    if "@sha256:" in image:  # digest pin: strongest form
        return None
    # the tag separator is a ':' AFTER the last '/', so registry ports
    # (registry:5000/img) don't read as tags
    tail = image.rsplit("/", 1)[-1]
    if ":" not in tail:
        return _finding(
            bundle, obj, "R06", SEV_ERROR, path,
            f"image {image!r} has no tag (floats to :latest); rollouts "
            "stop being reproducible",
            "pin a version tag or digest")
    if tail.rsplit(":", 1)[-1] == "latest":
        return _finding(
            bundle, obj, "R06", SEV_ERROR, path,
            f"image {image!r} is pinned to :latest, which is not a pin",
            "pin a version tag or digest")
    return None


def _r06_images_probes(bundle: _Bundle) -> List[Finding]:
    findings: List[Finding] = []
    for _loc, obj in bundle.workloads():
        pod = _pod_spec(obj)
        base = ".spec.template.spec"
        for cpath, c in _containers(pod):
            image = c.get("image")
            if image:
                f = _image_finding(bundle, obj,
                                   f"{base}.{cpath}.image", str(image))
                if f is not None:
                    findings.append(f)
            port_names: Set[str] = set()
            port_numbers: Set[str] = set()
            for p in c.get("ports") or []:
                if isinstance(p, dict):
                    if p.get("name"):
                        port_names.add(str(p["name"]))
                    if p.get("containerPort") is not None:
                        port_numbers.add(str(p["containerPort"]))
            for probe_field in ("readinessProbe", "livenessProbe",
                                "startupProbe"):
                probe = c.get(probe_field) or {}
                for action in ("httpGet", "tcpSocket"):
                    port = (probe.get(action) or {}).get("port")
                    if port is None:
                        continue
                    ppath = (f"{base}.{cpath}.{probe_field}"
                             f".{action}.port")
                    if isinstance(port, str) and not port.isdigit():
                        if port not in port_names:
                            findings.append(_finding(
                                bundle, obj, "R06", SEV_ERROR, ppath,
                                f"probe references named port {port!r} "
                                "which is not in this container's "
                                f"containerPorts (names: "
                                f"{sorted(port_names) or 'none'})",
                                "declare the named containerPort or "
                                "probe a declared one"))
                    elif (port_numbers and str(port) not in port_numbers
                          and "probe-port" not in _allows(obj)):
                        findings.append(_finding(
                            bundle, obj, "R06", SEV_WARN, ppath,
                            f"probe port {port} is not among the "
                            "declared containerPorts "
                            f"({sorted(port_numbers)})",
                            "declare the port or point the probe at a "
                            "declared one"))
    return findings


# --------------------------------------------------------------------------
# R07 — gang shape: multi-worker GPU Jobs take whole hosts, all at once


def _gpu_card_request(obj: Manifest, resource: str) -> Optional[int]:
    """The workload's per-pod card count, when it requests any (the
    first GPU-carrying container; R05 already enforces request==limit)."""
    for _cpath, c in _containers(_pod_spec(obj)):
        limits = (c.get("resources") or {}).get("limits") or {}
        requests = (c.get("resources") or {}).get("requests") or {}
        val = limits.get(resource, requests.get(resource))
        if val is None:
            continue
        try:
            return int(str(val))
        except ValueError:
            return None  # R05's finding; don't double-report
    return None


def _r07_gang_shape(bundle: _Bundle,
                    spec: Optional[ClusterSpec]) -> List[Finding]:
    """A multi-worker GPU Job is a gang: every worker must run at once,
    know its rank, and seat a whole host, or the job deadlocks waiting
    for peers that are not scheduled. A GPU host layout tiles no
    multi-host slice, so any worker count of whole hosts is a shape."""
    findings: List[Finding] = []
    if spec is None:
        return findings
    host = spec.gpu.host_type
    resource = spec.gpu.resource_name
    for _loc, obj in bundle.workloads():
        if obj.get("kind") != "Job":
            continue
        cards = _gpu_card_request(obj, resource)
        if cards is None:
            continue
        jspec = obj.get("spec") or {}
        completions = jspec.get("completions")
        parallelism = jspec.get("parallelism")
        workers = int(completions if completions is not None
                      else parallelism if parallelism is not None else 1)
        par = int(parallelism) if parallelism is not None else workers
        if workers <= 1 and par <= 1:
            continue  # single-worker: R05's range check suffices
        if par != workers:
            findings.append(_finding(
                bundle, obj, "R07", SEV_ERROR, ".spec.parallelism",
                f"GPU Job runs {workers} completion(s) at parallelism "
                f"{par}; a gang needs every worker running at once — "
                "any fewer deadlocks waiting for peers that are not "
                "scheduled",
                "set parallelism == completions"))
            continue
        if jspec.get("completionMode") != "Indexed":
            findings.append(_finding(
                bundle, obj, "R07", SEV_ERROR, ".spec.completionMode",
                f"multi-worker GPU Job ({workers} workers) without "
                "Indexed completion mode; workers cannot derive their "
                "rank (JOB_COMPLETION_INDEX)",
                "set completionMode: Indexed"))
        if cards != host.cards_per_host:
            findings.append(_finding(
                bundle, obj, "R07", SEV_ERROR,
                ".spec.template.spec.containers[0].resources",
                f"multi-worker GPU Job requests {cards} card(s)/worker "
                f"but {host.name} hosts carry {host.cards_per_host}; "
                "multi-host gangs take whole hosts or deadlock on "
                "a partially-held host",
                f"request {resource}: {host.cards_per_host} per worker"))
    return findings


# --------------------------------------------------------------------------
# entry points


def lint_groups(groups: Sequence[Sequence[Manifest]],
                spec: Optional[ClusterSpec] = None,
                external: Collection[str] = DEFAULT_EXTERNAL
                ) -> List[Finding]:
    """Run every rule over ``groups`` (the group-of-groups form)
    and return findings sorted most-severe-first, then by rule/object.
    ``spec`` enables the accelerator-aware half of R05; ``external``
    allowlists references expected to pre-exist on-cluster."""
    bundle = _Bundle(groups)
    findings: List[Finding] = []
    findings.extend(_r01_duplicates(bundle))
    findings.extend(_r02_references(bundle, external))
    findings.extend(_r03_selectors(bundle))
    findings.extend(_r04_ordering(bundle, external))
    findings.extend(_r05_gpu(bundle, spec))
    findings.extend(_r06_images_probes(bundle))
    findings.extend(_r07_gang_shape(bundle, spec))
    findings.sort(key=lambda f: (f.severity != SEV_ERROR, f.rule, f.kind,
                                 f.namespace, f.name, f.path))
    return findings


def errors(findings: Sequence[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEV_ERROR]


def format_table(findings: Sequence[Finding]) -> str:
    """Human-readable findings table (one line per finding) plus a
    summary count line — what ``python -m tpu_cluster_torch lint`` prints."""
    lines = [f.line() for f in findings]
    errs = len(errors(findings))
    lines.append(f"lint: {errs} error(s), {len(findings) - errs} "
                 "warning(s)")
    return "\n".join(lines)


def gate(groups: Sequence[Sequence[Manifest]], mode: str,
         spec: Optional[ClusterSpec] = None,
         external: Collection[str] = DEFAULT_EXTERNAL,
         log: Callable[[str], object] = lambda msg: None
         ) -> List[Finding]:
    """The pre-apply gate: lint ``groups`` before the rollout's first
    request. ``mode`` is ``off`` (no-op), ``warn`` (report every finding
    through ``log`` and proceed), or ``error`` (report, then raise
    :class:`LintGateError` when any error-severity finding exists —
    guaranteeing zero requests reach the apiserver)."""
    if mode not in ("off", "warn", "error"):
        raise ValueError(f"lint mode {mode!r}; expected off|warn|error")
    if mode == "off":
        return []
    findings = lint_groups(groups, spec=spec, external=external)
    for f in findings:
        log(f"lint: {f.line()}")
    errs = errors(findings)
    if mode == "error" and errs:
        raise LintGateError(
            f"lint gate: {len(errs)} error(s) in the rendered bundle; "
            "nothing was applied (run `python -m tpu_cluster_torch lint` "
            "for the full report, or --lint=warn to proceed anyway)")
    if findings:
        log(f"lint: {len(errs)} error(s), {len(findings) - len(errs)} "
            f"warning(s) — proceeding (--lint={mode}"
            + (": warnings do not block)" if mode == "error" else ")"))
    return findings
