"""Minimal Go-template renderer for the generated Helm chart: the port's
own copy of ``tpu_cluster/render/gotmpl.py``.

The stack installs with ``helm install --wait``. The chart
(``deploy/chart/gpu-stack``) is generated (:mod:`.chart`) from the
canonical manifests renderer, and its template language surface is tiny by
construction: ``{{ .Values.path }}`` interpolation, ``{{- if .Values.path }}
... {{- end }}`` guards, and ``{{/* comments */}}``. This module implements
exactly that subset with Go's whitespace-trim semantics, so tests (and
the CLI on clusters without helm) can render the chart's *template
semantics* — values switches toggling documents, ``--set`` overrides
reaching flags — without a helm binary. Real ``helm lint``/``helm
template`` stay the authoritative check; this renderer is strict (unknown constructs, unbalanced
blocks, or missing values raise TemplateError rather than degrading), so a
template that drifts outside the supported subset fails tests instead of
rendering wrong. PyYAML is imported only by :func:`render_chart`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

_TAG_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.DOTALL)


class TemplateError(ValueError):
    pass


def _lookup(values: Dict[str, Any], dotted: str) -> Any:
    """Resolve ``.Values.a.b`` against the values mapping; strict."""
    if not dotted.startswith(".Values."):
        raise TemplateError(f"unsupported reference {dotted!r} "
                            "(only .Values.* is in the chart's subset)")
    node: Any = values
    for part in dotted[len(".Values."):].split("."):
        if not isinstance(node, dict) or part not in node:
            raise TemplateError(f"undefined value {dotted!r}")
        node = node[part]
    return node


def _truthy(v: Any) -> bool:
    # Go template truth: false, 0, nil, empty string/collection are false.
    return bool(v)


def _gostr(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        raise TemplateError("cannot interpolate nil value")
    return str(v)


def _tokens(text: str) -> Iterator[Tuple[str, str]]:
    """Yield ("text", chunk) and ("tag", action) tokens with Go trim
    semantics applied ({{- trims preceding whitespace, -}} following)."""
    pos = 0
    pending_rtrim = False
    for m in _TAG_RE.finditer(text):
        chunk = text[pos:m.start()]
        if pending_rtrim:
            chunk = chunk.lstrip(" \t\n\r")
        if m.group(1) == "-":
            chunk = chunk.rstrip(" \t\n\r")
        yield ("text", chunk)
        yield ("tag", m.group(2))
        pending_rtrim = m.group(3) == "-"
        pos = m.end()
    tail = text[pos:]
    if pending_rtrim:
        tail = tail.lstrip(" \t\n\r")
    yield ("text", tail)


def render(text: str, values: Dict[str, Any]) -> str:
    """Render one template file; raises TemplateError on anything outside
    the generated chart's construct subset."""
    out: List[str] = []
    # Stack of emit-flags for nested if blocks; emitting iff all are True.
    stack: List[bool] = []
    for kind, payload in _tokens(text):
        emitting = all(stack)
        if kind == "text":
            if emitting:
                out.append(payload)
            continue
        action = payload
        if action.startswith("/*") and action.endswith("*/"):
            continue  # comment
        if action.startswith("if "):
            cond = action[3:].strip()
            # evaluate even in a suppressed branch: strictness over speed
            stack.append(_truthy(_lookup(values, cond)))
        elif action == "end":
            if not stack:
                raise TemplateError("unbalanced {{ end }}")
            stack.pop()
        elif action.startswith("."):
            if emitting:
                out.append(_gostr(_lookup(values, action)))
        else:
            raise TemplateError(f"unsupported template action {action!r}")
    if stack:
        raise TemplateError("unclosed {{ if }} block")
    rendered = "".join(out)
    if "{{" in rendered or "}}" in rendered:
        raise TemplateError("unrendered template markers left in output")
    return rendered


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def set_value(overrides: Dict[str, Any], dotted: str, value: Any) -> None:
    """``--set a.b=v`` analog: mutate ``overrides`` at the dotted path."""
    node = overrides
    parts = dotted.split(".")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
        if not isinstance(node, dict):
            raise TemplateError(f"--set {dotted}: {part} is not a mapping")
    node[parts[-1]] = value


def render_chart(chart_dir: str,
                 overrides: Optional[Dict[str, Any]] = None
                 ) -> List[Dict[str, Any]]:
    """``helm template`` analog: render every template against
    values.yaml (+ overrides) and parse the YAML documents, in template
    filename order (= the chart's rollout order)."""
    import yaml

    with open(os.path.join(chart_dir, "values.yaml"), encoding="utf-8") as f:
        values = yaml.safe_load(f) or {}
    if overrides:
        values = deep_merge(values, overrides)
    tdir = os.path.join(chart_dir, "templates")
    docs: List[Dict[str, Any]] = []
    for name in sorted(os.listdir(tdir)):
        with open(os.path.join(tdir, name), encoding="utf-8") as f:
            text = f.read()
        rendered = render(text, values)
        if name.startswith("_"):
            # helpers must not emit manifest content
            if rendered.strip():
                raise TemplateError(f"{name} rendered non-empty output")
            continue
        for doc in yaml.safe_load_all(rendered):
            if doc is not None:
                docs.append(doc)
    return docs
