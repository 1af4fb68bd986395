"""The port's CLI (``python -m tpu_cluster_torch``): the commands of the
reference's ``tpuctl`` (``tpu_cluster/__main__.py``), with its flags,
defaults, messages and exit codes.

  render   cluster spec -> node-prep / kubeadm scripts, operand manifests,
           validation Jobs, operator install, operator bundle
  lint     static cross-object analysis of the rendered bundle (rules
           R01-R07: duplicates, dangling refs, selectors, apply order,
           GPU resource sanity, image pins, gang shape)
  apply    rollout against the apiserver, gating each group on readiness
           (--operator deploys the in-cluster controller instead); runs
           the linter first (--lint=warn default, error blocks pre-request);
           applies via server-side apply by default (--apply-mode) with a
           sticky merge-patch fallback for pre-SSA apiservers
  delete   remove everything a spec renders, reverse order
           (helm uninstall analog)
  events   list or stream (--follow) the Kubernetes Events the stack's
           controllers record (Retrying/RetryExhausted, HedgeFired,
           WatchResumed ...), each row joined with the rollout trace that
           caused it via the tpu-stack.dev/traceparent annotation
  verify   the executable acceptance runbook
  triage   the executable troubleshooting runbook
  queue    the gang-admission queue (admitted, queued, preempted gangs
           with reasons and reserved hosts)
  admission  the gang-admission control loop (--once, --watch)
  maintain   rolling maintenance waves: plan | run | status
  autoscale  the metrics-driven serving autoscaler: run | status
  slo      multi-window multi-burn-rate SLO evaluation over span-derived
           samples (`slo check TRACE...`, exit 1 when a budget burns)
           or, with `--live --targets JOB=URL`, over scraped counters
  dash     terminal dashboard over a scrape-fed time-series store
           (`--once --replay FILE` renders a frame from a dumped TSDB)
  trace    merge per-process Chrome traces into one timeline, or
           validate one against the trace-event schema
  top      per-phase/per-object breakdown of an `apply --trace-out` trace
  conlint  concurrency lint over the port's sources (CL01-CL05)
  pinlint  contract pin audit: the port's registry against the native
           operator's C++ tables, the enforcer files, docs and CI

    python -m tpu_cluster_torch render --out DIR [--spec FILE] [--multihost N]
    python -m tpu_cluster_torch lint [--strict] [--operator] [--format json]
    python -m tpu_cluster_torch apply [--apiserver URL] [--wait] [--operator]
    python -m tpu_cluster_torch delete [--apiserver URL] [--operator]
    python -m tpu_cluster_torch events --apiserver URL [--for OBJ] [--follow]
    python -m tpu_cluster_torch verify [--config all|CHECKS] [--json]
    python -m tpu_cluster_torch triage
    python -m tpu_cluster_torch queue --apiserver URL [GANG] [--json]
    python -m tpu_cluster_torch admission --apiserver URL [--once|--watch]
    python -m tpu_cluster_torch maintain plan|run|status --apiserver URL
    python -m tpu_cluster_torch autoscale run|status --apiserver URL
    python -m tpu_cluster_torch slo check TRACE... | --live --targets JOB=URL
    python -m tpu_cluster_torch dash --targets JOB=URL [--once] | --replay FILE
    python -m tpu_cluster_torch trace merge -o OUT TRACE... | validate FILE
    python -m tpu_cluster_torch top TRACE
    python -m tpu_cluster_torch conlint [PATH...] [--format json]
    python -m tpu_cluster_torch pinlint [--strict] [--dump] [--format json]

The REST backend (``--apiserver``) needs no PyYAML, nor do the
observability and lint commands; the kubectl backend and ``render``
import it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

from . import admission as admissionmod
from . import autoscale as autoscalemod
from . import conlint as conlintmod
from . import events as eventsmod
from . import kubeapply
from . import lint as lintmod
from . import maintenance as maintenancemod
from . import metricsdb as metricsdbmod
from . import slo as slomod
from . import spec as specmod
from . import telemetry, triage, verify
from .render import jobs, kubeadm, manifests, nodeprep, operator_bundle


def _load_spec(path: str) -> specmod.ClusterSpec:
    return specmod.load_file(path) if path else specmod.default_spec()


def _render_artifacts(spec: specmod.ClusterSpec,
                      multihost: int) -> Dict[str, str]:
    """name -> rendered text for every artifact the spec produces."""
    import yaml

    return {
        "nodeprep": nodeprep.render_node_prep(spec),
        "kubeadm-packages": nodeprep.render_kubeadm_packages(spec),
        "kubeadm-init": kubeadm.render_init_script(spec),
        "kubeadm-join": kubeadm.render_join_script(spec),
        "smoke-check": kubeadm.render_smoke_check(spec),
        "manifests": manifests.render_all(spec),
        "jobs": yaml.dump_all(
            jobs.render_validation_jobs(spec.gpu, multihost), sort_keys=False),
        "operator": yaml.dump_all(
            operator_bundle.operator_install(spec), sort_keys=False),
        "bundle": json.dumps(operator_bundle.bundle_files(spec), indent=2),
    }


_EXT = {"nodeprep": "sh", "kubeadm-packages": "sh", "kubeadm-init": "sh",
        "kubeadm-join": "sh", "smoke-check": "sh", "manifests": "yaml",
        "jobs": "yaml", "operator": "yaml", "bundle": "json"}


def cmd_render(args) -> int:
    spec = _load_spec(args.spec)
    try:
        artifacts = _render_artifacts(spec, args.multihost)
    except ValueError as exc:
        print(f"render: {exc}", file=sys.stderr)
        return 2
    if args.only:
        print(artifacts[args.only], end="")
        return 0
    if not args.out:
        print("render: pass --only <name> to print one artifact or "
              f"--out DIR for all; names: {', '.join(artifacts)}",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    for name, text in artifacts.items():
        path = os.path.join(args.out, f"{name}.{_EXT[name]}")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        print(path)
    return 0


def _retry_policy(args) -> kubeapply.RetryPolicy:
    """The rollout failure taxonomy, tuned by --retry-attempts/--retry-base
    (429/5xx/transport retried with jittered exponential backoff honoring
    Retry-After; 409 re-GET-then-re-PATCH; other 4xx terminal)."""
    return kubeapply.RetryPolicy(attempts=max(1, args.retry_attempts),
                                 base_s=max(0.0, args.retry_base))

def _rest_client(args):
    """Client for --apiserver mode, or None for the kubectl backend."""
    if not args.apiserver:
        return None
    token = ""
    if args.token_file:
        with open(args.token_file, encoding="utf-8") as f:
            token = f.read().strip()
    return kubeapply.Client(
        args.apiserver, token=token, ca_file=args.ca_file,
        insecure_skip_tls_verify=args.insecure_skip_tls_verify,
        retry=_retry_policy(args),
        # fleet-scale knobs: the multiplexed transport pool
        # and the paginated-LIST page size (both default OFF — the
        # pre-fleet byte-identical paths)
        mux=(getattr(args, "mux", None) or None),
        list_page_limit=(getattr(args, "page_limit", None) or None))

def _kubectl_mode_flags_ok(args, cmd: str) -> bool:
    if args.token_file or args.ca_file:
        print(f"{cmd}: --token-file/--ca-file need --apiserver "
              "(the kubectl backend authenticates via kubeconfig)",
              file=sys.stderr)
        return False
    return True


def _spec_groups(args):
    """(spec, groups): the rendered bundle an apply/delete/lint command
    operates on — operand rollout groups, or the operator install waves
    with --operator (the TpuStackPolicy CR must trail its CRD's
    establishment, see operator_bundle.operator_install_groups)."""
    spec = _load_spec(args.spec)
    if args.operator:
        return spec, operator_bundle.operator_install_groups(spec)
    return spec, manifests.rollout_groups(spec)


def _lint_external(args):
    """The pre-existing-on-cluster allowlist: built-ins plus every
    --allow-external the invocation carried (shared by lint and the
    apply gate, so a waiver that satisfies `lint` also satisfies
    `apply --lint=error`)."""
    return frozenset(lintmod.DEFAULT_EXTERNAL) | \
        frozenset(getattr(args, "allow_external", None) or [])

def _flight_recorder_path(args) -> str:
    """Where the always-on flight recorder dumps: the explicit flag, or
    a stable PER-USER file in the system temp dir ('' = disabled via
    --flight-recorder=off). Per-user (uid suffix) on purpose: a shared
    well-known name in a world-writable directory would let one user's
    dump collide with — or be squatted by — another's; the atomic
    writer's mkstemp scratch file covers the symlink half."""
    if args.flight_recorder == "off":
        return ""
    if args.flight_recorder:
        return args.flight_recorder
    import tempfile
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(),
                        f"tpuctl-flight-{uid}.json")

def cmd_apply(args) -> int:
    spec, groups = _spec_groups(args)
    # REST backend: telemetry is ALWAYS armed — the bounded flight
    # recorder rides on it, so a crashed rollout leaves a post-mortem
    # trace even when --trace-out wasn't passed. The kubectl
    # backend delegates the wire to kubectl, so telemetry stays opt-in
    # there (the spans would be empty anyway — see the note below).
    # Library callers are untouched: Client.telemetry defaults to None,
    # zero overhead.
    recorder = None
    rest_mode = bool(args.apiserver)
    fr_path = _flight_recorder_path(args) if rest_mode else ""
    if fr_path:
        recorder = telemetry.FlightRecorder(fr_path)
    # armed only when SOMETHING consumes it: the recorder (on by
    # default, --flight-recorder=off disables), an output flag, or an
    # armed Events recorder (which stamps each Event with the run's
    # trace id and counts emit failures) — an explicit full opt-out
    # must get the telemetry=None zero-overhead path, not an unconsumed
    # span tree
    tel = (telemetry.Telemetry(recorder=recorder)
           if (recorder is not None or args.trace_out or args.metrics_out
               or (rest_mode and args.events))
           else None)
    if rest_mode:
        # SIGTERM must dump, like a crash: raising SystemExit lets the
        # finally block below flush the recorder and write --trace-out
        # before the process dies with the conventional 143. (A SIGKILL
        # can't be caught — that's what the recorder's incremental
        # atomic flushes are for.)
        import signal as _signal

        def _on_sigterm(signum, frame):  # pragma: no cover - signal path
            raise SystemExit(128 + signum)

        try:
            _signal.signal(_signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread (embedded use): no handler
    if args.max_inflight is not None and not args.parallel:
        print("apply: note: --max-inflight has no effect without "
              "--parallel", file=sys.stderr)
    if args.parallel and args.max_inflight is not None \
            and args.max_inflight < 2:
        print("apply: --max-inflight must be >= 2 with --parallel (the "
              "pipelined engine is the concurrent path; drop --parallel "
              "for the sequential one)", file=sys.stderr)
        return 2
    max_inflight = ((8 if args.max_inflight is None else args.max_inflight)
                    if args.parallel else 1)
    if args.resume and not args.journal:
        print("apply: --resume needs --journal PATH (the journal a "
              "previous run recorded)", file=sys.stderr)
        return 2
    journal = None
    if args.journal:
        journal = kubeapply.RolloutJournal(args.journal, groups,
                                           resume=args.resume)
        if args.resume and not journal.resumed:
            # missing file or a different rendered bundle: resuming it
            # would skip work that never happened — say so, start fresh
            print("apply: note: journal absent or from a different bundle; "
                  "starting a fresh rollout", file=sys.stderr)
        elif args.resume:
            print("apply: resuming from journal "
                  f"{args.journal} (completed groups will be skipped)")
    # The rollout-wide deadline budget (--deadline): armed HERE, before
    # the first request, so render/lint time already spent counts too on
    # the kubectl path's clamps; both backends thread it through.
    budget = (kubeapply.DeadlineBudget(args.deadline)
              if args.deadline is not None else None)
    try:
        client = _rest_client(args)
        if client is not None:
            client.telemetry = tel
            client.budget = budget
            client.hedge_s = args.hedge
            if args.events:
                # the Events pipeline: operational Events
                # (Retrying/RetryExhausted/DeadlineExceeded/HedgeFired/
                # WatchResumed) recorded next to the objects they
                # happened for — fail-open, one attempt each, never on
                # the critical path
                client.events = eventsmod.EventRecorder(
                    client, component="tpuctl", telemetry=tel)
            try:
                result = kubeapply.apply_groups(
                    client, groups, wait=args.wait,
                    stage_timeout=args.stage_timeout, poll=args.poll,
                    allow_empty_daemonsets=args.allow_empty_daemonsets,
                    log=lambda msg: print(msg), max_inflight=max_inflight,
                    watch_ready=args.watch, journal=journal,
                    lint_mode=args.lint, lint_spec=spec,
                    lint_external=_lint_external(args),
                    apply_mode=args.apply_mode)
            finally:
                client.close()
            if client.retries:
                print(f"apply: retried {client.retries} request(s) "
                      "against a flaky apiserver")
            if client.hedges:
                print(f"apply: hedged {client.hedges} slow idempotent "
                      "read(s) with backup attempts")
            if args.wait:
                print(f"rollout phases: {result.timings_line()}")
        else:
            if not _kubectl_mode_flags_ok(args, "apply"):
                return 2
            if args.parallel:
                print("apply: note: --parallel has no effect on the kubectl "
                      "backend (kubectl apply already batches per group); "
                      "pass --apiserver to use the pipelined engine",
                      file=sys.stderr)
            if args.watch:
                print("apply: note: --watch has no effect on the kubectl "
                      "backend (kubectl rollout status blocks on its own "
                      "watch); pass --apiserver for event-driven readiness",
                      file=sys.stderr)
            if args.apply_mode != "auto":
                print("apply: note: --apply-mode has no effect on the "
                      "kubectl backend (kubectl apply manages its own "
                      "patching); pass --apiserver for server-side apply",
                      file=sys.stderr)
            if args.poll != 1.0:
                print("apply: note: --poll has no effect on the kubectl "
                      "backend (kubectl rollout status does its own "
                      "polling)", file=sys.stderr)
            if args.hedge is not None:
                print("apply: note: --hedge has no effect on the kubectl "
                      "backend (kubectl owns its own transport); pass "
                      "--apiserver for hedged reads", file=sys.stderr)
            if args.events:
                print("apply: note: --events has no effect on the "
                      "kubectl backend (the recorder posts through the "
                      "REST client); pass --apiserver for the Events "
                      "pipeline", file=sys.stderr)
            if tel is not None:
                print("apply: note: --trace-out/--metrics-out instrument "
                      "the REST engine's requests; the kubectl backend "
                      "delegates the wire to kubectl, so its outputs "
                      "will be empty — pass --apiserver for a real trace",
                      file=sys.stderr)
            # no URL given: use kubectl from PATH (the reference guide's
            # control-plane-node workflow)
            kubeapply.apply_groups_kubectl(
                groups, wait=args.wait, stage_timeout=args.stage_timeout,
                allow_empty_daemonsets=args.allow_empty_daemonsets,
                log=lambda msg: print(msg), retry=_retry_policy(args),
                journal=journal, lint_mode=args.lint, lint_spec=spec,
                lint_external=_lint_external(args), budget=budget)
    except kubeapply.ApplyError as exc:
        print(f"apply failed: {exc}", file=sys.stderr)
        if recorder is not None:
            print(f"apply: flight recorder dump (last "
                  f"{recorder.capacity} spans/retries): {recorder.path}",
                  file=sys.stderr)
        return 1
    finally:
        if journal is not None:
            journal.close()
        if recorder is not None:
            # final flush on EVERY exit path — converged, ApplyError,
            # SIGTERM's SystemExit — so the on-disk ring is current
            recorder.flush()
        # written even when the rollout FAILED: a crashed rollout's trace
        # (unfinished spans marked, retries annotated) is the one worth
        # reading. An unwritable output path must not crash a converged
        # rollout or mask a real ApplyError — report and move on.
        if tel is not None and args.trace_out:
            try:
                tel.write_trace(args.trace_out)
                print(f"apply: trace written to {args.trace_out} "
                      "(chrome://tracing / Perfetto; summarize with "
                      f"`python -m tpu_cluster_torch top "
                      f"{args.trace_out}`)")
            except OSError as exc:
                print(f"apply: cannot write trace to {args.trace_out}: "
                      f"{exc}", file=sys.stderr)
        if tel is not None and args.metrics_out:
            try:
                tel.write_metrics(args.metrics_out)
                print(f"apply: metrics written to {args.metrics_out}")
            except OSError as exc:
                print(f"apply: cannot write metrics to "
                      f"{args.metrics_out}: {exc}", file=sys.stderr)
    print("apply: converged" if args.wait else "apply: submitted")
    return 0

def cmd_delete(args) -> int:
    _spec, groups = _spec_groups(args)
    try:
        client = _rest_client(args)
        if client is not None:
            try:
                kubeapply.delete_groups(client, groups,
                                        log=lambda msg: print(msg))
            finally:
                client.close()
        else:
            if not _kubectl_mode_flags_ok(args, "delete"):
                return 2
            kubeapply.delete_groups_kubectl(groups,
                                            log=lambda msg: print(msg))
    except kubeapply.ApplyError as exc:
        print(f"delete failed: {exc}", file=sys.stderr)
        return 1
    print("delete: done")
    return 0


def cmd_conlint(args) -> int:
    """Concurrency lint (dev surface): the guarded-by annotation checker
    over Python sources — `conlint` with no paths audits the port's
    package."""
    argv = list(args.paths)
    if args.format != "table":
        argv += ["--format", args.format]
    return conlintmod.main(argv)


def cmd_pinlint(args) -> int:
    """Contract pin audit (dev surface): the registry-vs-C++/docs/CI
    differ — `pinlint --strict` is the gate, `--dump` prints the
    registry itself."""
    from . import pinlint as pinlintmod
    argv = []
    if args.strict:
        argv.append("--strict")
    if args.dump:
        argv.append("--dump")
    if args.format != "table":
        argv += ["--format", args.format]
    if args.native_root:
        argv += ["--native-root", args.native_root]
    return pinlintmod.main(argv)


def cmd_lint(args) -> int:
    """Static cross-object analysis of the rendered bundle. Exit 0 = clean
    (warnings tolerated unless --strict), 1 = findings, 2 = bad
    invocation/spec."""
    spec, groups = _spec_groups(args)
    findings = lintmod.lint_groups(groups, spec=spec,
                                   external=_lint_external(args))
    errs = lintmod.errors(findings)
    failing = findings if args.strict else errs
    if args.format == "json":
        print(json.dumps({
            "ok": not failing,
            "errors": len(errs),
            "warnings": len(findings) - len(errs),
            "strict": args.strict,
            "findings": [f.to_dict() for f in findings],
        }))
    else:
        print(lintmod.format_table(findings),
              file=sys.stderr if failing else sys.stdout)
    return 1 if failing else 0


def cmd_queue(args) -> int:
    """The gang queue, read-side: gang-annotated Jobs joined with the
    published reservation ConfigMap. `queue GANG` prints one gang's
    detail block (reserved hosts + card indices)."""
    if not args.apiserver:
        print("queue: --apiserver URL required (the gang queue lives on "
              "the cluster)", file=sys.stderr)
        return 2
    spec = _load_spec(args.spec)
    ns = args.namespace or spec.gpu.namespace
    client = _rest_client(args)
    assert client is not None
    try:
        views = admissionmod.fetch_queue(client, ns)
        cordoned = admissionmod.fetch_cordoned(client)
    finally:
        client.close()
    if args.gang:
        found = [v for v in views if v.name == args.gang]
        if args.json:
            import dataclasses
            print(json.dumps({"namespace": ns, "gangs": [
                dataclasses.asdict(v) for v in found]}))
        else:
            print(admissionmod.describe_gang(views, args.gang))
        return 0 if found else 1
    if args.json:
        import dataclasses
        print(json.dumps({"namespace": ns,
                          "gangs": [dataclasses.asdict(v) for v in views],
                          "cordoned": [{"host": h, "group": g}
                                       for h, g in cordoned]}))
        return 0
    print(admissionmod.format_queue(views))
    # cordon state rides the queue listing: a queued gang's
    # "waiting on cordoned host group" reason should be resolvable from
    # the same screen
    block = admissionmod.format_cordoned(cordoned)
    if block:
        print(block)
    return 0


def cmd_admission(args) -> int:
    """Run the gang-admission control loop (one pass with --once, else
    poll at --interval until interrupted). Writes the reservation
    ConfigMap and per-Job decision annotations as it goes."""
    if not args.apiserver:
        print("admission: --apiserver URL required (the admission loop "
              "is a REST controller)", file=sys.stderr)
        return 2
    spec = _load_spec(args.spec)
    ns = args.namespace or spec.gpu.namespace
    # events need a Telemetry even when no trace/metrics file was
    # asked for: the recorder stamps each decision Event with the
    # run's trace id, which is what `events` joins on. Span
    # retention follows --trace-out: without it nothing ever exports
    # the span tree, and the forever-running loop must not grow one
    # admission-pass tree per pass until it OOMs (the metrics registry
    # and the traceparent stamp — the parts events/--metrics-out
    # consume — are bounded and unaffected)
    tel = (telemetry.Telemetry(retain_spans=bool(args.trace_out))
           if (args.trace_out or args.metrics_out or args.events
               or args.metrics_port)
           else None)
    client = _rest_client(args)
    assert client is not None
    client.telemetry = tel
    # --metrics-port: serve the loop's LIVE registry so the admission/
    # informer controller becomes a first-class scrape target.
    # Fail-open on bind conflict by contract: two loops racing
    # for one port must not take the arbitration down — warn, continue
    # unscraped.
    metrics_server = None
    if args.metrics_port:
        assert tel is not None
        try:
            # OverflowError: an out-of-range port fails the BIND like a
            # conflict does, and must get the same fail-open treatment
            metrics_server = metricsdbmod.MetricsServer(
                tel.metrics, args.metrics_port).start()
            print(f"admission: serving /metrics on "
                  f"{metrics_server.url}")
        except (OSError, OverflowError) as exc:
            print(f"admission: cannot bind metrics port "
                  f"{args.metrics_port} ({exc}); continuing without "
                  "a metrics endpoint", file=sys.stderr)
    # decision Events are ON by default for the admission CLI (the
    # controller's decisions are exactly what `events --for`
    # exists to show); --no-events restores the annotation-only loop
    recorder = (eventsmod.EventRecorder(client, component="gpu-admission",
                                        telemetry=tel)
                if args.events else None)
    ctrl = admissionmod.AdmissionController(client, ns, telemetry=tel,
                                            events=recorder)
    rc = 0
    try:
        if args.once:
            print(ctrl.step().line())
        elif args.watch:
            print(f"admission: watch-driven arbitration in namespace "
                  f"{ns} (informers over nodes + jobs; resync backstop "
                  f"{args.interval:g}s; ctrl-c to stop)")

            def _report(result) -> None:
                if (result.newly_admitted or result.preempted
                        or result.drained):
                    print(result.line())

            ctrl.run_watch(resync=args.interval, on_pass=_report)
        else:
            print(f"admission: arbitrating gangs in namespace {ns} every "
                  f"{args.interval:g}s (ctrl-c to stop)")
            while True:
                try:
                    result = ctrl.step()
                except kubeapply.ApplyError as exc:
                    # a long-running controller must outlive apiserver
                    # outages: the loop is the outer retry (same
                    # discipline as AdmissionController.run) — report
                    # and keep arbitrating
                    print(f"admission: pass failed ({exc}); retrying",
                          file=sys.stderr)
                else:
                    if (result.newly_admitted or result.preempted
                            or result.drained):
                        print(result.line())
                time.sleep(args.interval)
    except KeyboardInterrupt:
        print("admission: stopped")
    except kubeapply.ApplyError as exc:
        # --once: one failed pass IS the result
        print(f"admission: {exc}", file=sys.stderr)
        rc = 1
    finally:
        client.close()
        if metrics_server is not None:
            metrics_server.stop()
        if tel is not None and args.trace_out:
            try:
                tel.write_trace(args.trace_out)
            except OSError as exc:
                print(f"admission: cannot write trace: {exc}",
                      file=sys.stderr)
        if tel is not None and args.metrics_out:
            try:
                tel.write_metrics(args.metrics_out)
            except OSError as exc:
                print(f"admission: cannot write metrics: {exc}",
                      file=sys.stderr)
    return rc


def cmd_maintain(args) -> int:
    """Rolling maintenance orchestration (cordon/drain/upgrade waves):
    `plan` renders the wave groups a live fleet would get, `status`
    reads the published wave state, `run` drives the crash-restartable
    controller (--once for a single CI/scripting pass)."""
    if not args.apiserver:
        print("maintain: --apiserver URL required (maintenance acts on "
              "the cluster)", file=sys.stderr)
        return 2
    spec = _load_spec(args.spec)
    ns = args.namespace or spec.gpu.namespace
    client = _rest_client(args)
    assert client is not None
    rc = 0
    try:
        if args.maintain_cmd == "plan":
            plan = maintenancemod.plan_from_cluster(
                client, args.target, group_size=args.group_size,
                budget=maintenancemod.GangDisruptionBudget(
                    max_drained_gangs=args.budget,
                    min_available_groups=args.min_available))
            print(maintenancemod.format_plan(plan))
        elif args.maintain_cmd == "status":
            state = maintenancemod.fetch_state(client, ns)
            print(maintenancemod.format_status(state))
            if state is None:
                rc = 1  # the not-found contract, queue-style
        else:  # run
            plan = None
            if args.target:
                plan = maintenancemod.plan_from_cluster(
                    client, args.target, group_size=args.group_size,
                    budget=maintenancemod.GangDisruptionBudget(
                        max_drained_gangs=args.budget,
                        min_available_groups=args.min_available))
            # the recorder needs a Telemetry for the traceparent stamp
            # (same reasoning as cmd_admission); spans stay unretained —
            # the forever loop must not grow a pass tree per pass
            tel = telemetry.Telemetry(retain_spans=False)
            client.telemetry = tel
            recorder = (eventsmod.EventRecorder(
                client, component="gpu-maintenance", telemetry=tel)
                if args.events else None)
            ctrl = maintenancemod.MaintenanceController(
                client, ns, plan=plan, telemetry=tel, events=recorder)
            if args.once:
                print(ctrl.step().line())
            else:
                print(f"maintain: driving wave in namespace {ns} every "
                      f"{args.interval:g}s until complete (ctrl-c to "
                      "stop)")
                last = ""
                while True:
                    try:
                        result = ctrl.step()
                    except kubeapply.ApplyError as exc:
                        # phases persist and desired node state is
                        # recomputed each pass — the loop is the outer
                        # retry, nothing is lost
                        print(f"maintain: pass failed ({exc}); retrying",
                              file=sys.stderr)
                    else:
                        if (result.transitions or result.wave_completed
                                or result.blocked_on):
                            line = result.line()
                            if line != last:  # a held budget repeats
                                print(line)
                            last = line
                        if result.complete:
                            print("maintain: wave complete")
                            break
                    time.sleep(args.interval)
    except KeyboardInterrupt:
        print("maintain: stopped")
    except kubeapply.ApplyError as exc:
        print(f"maintain: {exc}", file=sys.stderr)
        rc = 1
    finally:
        client.close()
    return rc


def cmd_autoscale(args) -> int:
    """Metrics-driven serving autoscaler (HPA analog for gang-scheduled
    replicas): `run` scrapes the replica targets and converges the
    gang-annotated serving Jobs toward the windowed-load decision
    (--once for a single crash-restartable CI/scripting pass), `status`
    reads the published autoscale state."""
    if not args.apiserver:
        print("autoscale: --apiserver URL required (the autoscaler "
              "acts on the cluster)", file=sys.stderr)
        return 2
    spec = _load_spec(args.spec)
    ns = args.namespace or spec.gpu.namespace
    client = _rest_client(args)
    assert client is not None
    rc = 0
    try:
        if args.autoscale_cmd == "status":
            state = autoscalemod.fetch_state(client, ns)
            print(autoscalemod.format_status(state))
            if state is None:
                rc = 1  # the not-found contract, queue-style
        else:  # run
            try:
                targets = _parse_targets(args.targets)
                policy = autoscalemod.AutoscalePolicy(
                    min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas,
                    duty_high=args.duty_high, duty_low=args.duty_low,
                    queue_high=args.queue_high, window_s=args.window,
                    cooldown_s=args.cooldown)
                policy.validate()
            except ValueError as exc:
                print(f"autoscale: {exc}", file=sys.stderr)
                return 2
            # the recorder needs a Telemetry for the traceparent stamp;
            # spans stay unretained (same reasoning as cmd_maintain)
            tel = telemetry.Telemetry(retain_spans=False)
            client.telemetry = tel
            recorder = (eventsmod.EventRecorder(
                client, component="gpu-autoscale", telemetry=tel)
                if args.events else None)
            ctrl = autoscalemod.AutoscaleController(
                client, ns, job=args.job, accelerator=args.accelerator,
                policy=policy, targets=targets, telemetry=tel,
                events=recorder)
            if args.once:
                # a fresh process has an empty TSDB: take the warm-up
                # scrapes the decision window needs, then one pass
                # (step() itself scrapes once more)
                for _ in range(max(0, args.scrape_passes - 1)):
                    if ctrl.scrape is not None:
                        ctrl.scrape.scrape_once()
                    time.sleep(args.scrape_interval)
                print(ctrl.step().line())
            else:
                print(f"autoscale: driving {args.job} in namespace "
                      f"{ns} every {args.interval:g}s (ctrl-c to stop)")
                last = ""
                while True:
                    try:
                        result = ctrl.step()
                    except kubeapply.ApplyError as exc:
                        # state persists and Job convergence is
                        # level-triggered — the loop is the outer retry
                        print(f"autoscale: pass failed ({exc}); "
                              "retrying", file=sys.stderr)
                    else:
                        line = result.line()
                        if (result.verdict != autoscalemod.VERDICT_HOLD
                                or result.applied or result.deleted
                                or line != last):
                            print(line)
                        last = line
                    time.sleep(args.interval)
    except KeyboardInterrupt:
        print("autoscale: stopped")
    except kubeapply.ApplyError as exc:
        print(f"autoscale: {exc}", file=sys.stderr)
        rc = 1
    finally:
        client.close()
    return rc


def _parse_targets(specs):
    """--targets JOB=URL list -> [metricsdb.Target] (ValueError names
    the offending spec)."""
    return [metricsdbmod.parse_target(spec) for spec in specs]


def _print_event_rows(client, rows, as_json: bool) -> None:
    cache: Dict[str, str] = {}
    joined = [(e, eventsmod.trace_of_event(client, e, cache))
              for e in rows]
    if as_json:
        print(json.dumps({"events": [
            dict(e, trace=t) for e, t in joined]}))
        return
    print(eventsmod.EVENT_HEADER)
    for e, t in joined:
        print(eventsmod.format_event_row(e, t))
    if not joined:
        print("(no events)")

def _follow_events(client, namespaces, args) -> int:
    """`events --follow`: print the current Events of every
    target namespace, then stream new/updated ones off ?watch=1
    streams until interrupted (or --follow-seconds elapses — the
    scripting/test bound). Each namespace's initial rows and its watch
    resourceVersion come from the SAME collection GET, so an Event
    posted between listing and watching is never silently skipped.
    With several namespaces (the default: the GPU namespace plus
    'default', where Events about cluster-scoped objects land) the
    watches round-robin on short windows — one connection at a time,
    worst-case inter-namespace latency one window."""
    colls = [f"/api/v1/namespaces/{ns}/events" for ns in namespaces]
    cache: Dict[str, str] = {}
    rv: Dict[str, str] = {}
    rows = []
    for coll in colls:
        code, body = client.get(coll)
        if code == 200:
            rv[coll] = str(((body or {}).get("metadata") or {})
                           .get("resourceVersion") or "")
            rows.extend((body or {}).get("items") or [])
        else:
            rv[coll] = ""
    rows.sort(key=lambda e: (str(e.get("lastTimestamp", "")),
                             str((e.get("metadata") or {})
                                 .get("name", ""))))
    if args.for_:
        rows = [e for e in rows if eventsmod.event_matches(e, args.for_)]
    print(eventsmod.EVENT_HEADER, flush=True)
    for e in rows:
        print(eventsmod.format_event_row(
            e, eventsmod.trace_of_event(client, e, cache)), flush=True)
    deadline = (time.monotonic() + args.follow_seconds
                if args.follow_seconds > 0 else None)
    # single namespace: long windows (one mostly-idle connection);
    # several: short windows so each namespace is streamed in turn
    max_window = 30 if len(colls) == 1 else 2
    try:
        while deadline is None or time.monotonic() < deadline:
            for coll in colls:
                left = (deadline - time.monotonic()
                        if deadline is not None else max_window)
                if left <= 0:
                    break
                window = max(1, min(max_window, int(left) + 1))
                try:
                    conn, resp = client._open_watch(coll, rv[coll],
                                                    window)
                except (kubeapply._WatchDenied, OSError) as exc:
                    print(f"events: watch failed ({exc}); retrying",
                          file=sys.stderr)
                    time.sleep(0.5)
                    continue
                try:
                    while deadline is None \
                            or time.monotonic() < deadline:
                        try:
                            raw = resp.readline()
                        except OSError:
                            # stream died (apiserver restart, reset):
                            # re-open from the held RV, same as the
                            # informer's pump
                            break
                        if not raw:
                            break  # window over: re-open from held RV
                        try:
                            ev = json.loads(raw)
                        except ValueError:
                            continue
                        obj = ev.get("object") or {}
                        if ev.get("type") == "ERROR":
                            rv[coll] = ""  # compacted: resume from now
                            break
                        new_rv = (obj.get("metadata") or {}).get(
                            "resourceVersion")
                        if new_rv:
                            rv[coll] = str(new_rv)
                        if ev.get("type") == "DELETED" \
                                or obj.get("kind") != "Event":
                            continue
                        if args.for_ and not eventsmod.event_matches(
                                obj, args.for_):
                            continue
                        print(eventsmod.format_event_row(
                            obj, eventsmod.trace_of_event(client, obj,
                                                          cache)),
                              flush=True)
                finally:
                    conn.close()
    except KeyboardInterrupt:
        pass
    return 0

def cmd_events(args) -> int:
    """List or stream the Events the stack's controllers record (the
    third observability pillar): `events [--for OBJ]` joins each
    row with the causing rollout trace; `--follow` streams."""
    if not args.apiserver:
        print("events: --apiserver URL required (Events live on the "
              "cluster)", file=sys.stderr)
        return 2
    spec = _load_spec(args.spec)
    namespaces = ([args.namespace] if args.namespace
                  else [spec.gpu.namespace, "default"])
    namespaces = list(dict.fromkeys(namespaces))
    client = _rest_client(args)
    assert client is not None
    try:
        if args.follow:
            return _follow_events(client, namespaces, args)
        rows = eventsmod.fetch_events(client, namespaces)
        if args.for_:
            rows = [e for e in rows
                    if eventsmod.event_matches(e, args.for_)]
        _print_event_rows(client, rows, args.json)
    finally:
        client.close()
    return 0


def _slo_live_report(args):
    """The `slo check --live` evidence pass: scrape every target for
    --duration at --scrape-interval into a fresh TSDB, then evaluate
    the SLO set over the scraped counter ratios (same verdict math and
    report shape as the trace path). Down targets are noted on stderr
    — a dead target is `up 0` data, never an exception (the
    ScrapeManager's fail-open contract)."""
    targets = _parse_targets(args.targets)
    tsdb = metricsdbmod.TSDB()
    manager = metricsdbmod.ScrapeManager(
        targets, tsdb, interval_s=args.scrape_interval,
        timeout_s=args.scrape_timeout)
    try:
        deadline = time.monotonic() + max(0.0, args.duration)
        manager.scrape_once()
        while time.monotonic() < deadline:
            time.sleep(max(0.01, args.scrape_interval))
            manager.scrape_once()
    finally:
        manager.stop()
    for job, up in sorted(manager.up_snapshot().items()):
        if not up:
            print(f"slo: note: target {job} is down (up 0) — its "
                  "families contribute no live samples",
                  file=sys.stderr)
    return metricsdbmod.live_slo_report(tsdb, scale=args.scale)


def cmd_slo(args) -> int:
    """`slo check TRACE...`: evaluate the SLO set as
    multi-window multi-burn-rate rules over span-derived samples —
    or, with `--live --targets JOB=URL...`, over counter ratios
    scraped from live /metrics endpoints. Exit 0 = every error budget
    healthy, 1 = burning (window pair named), 2 = unreadable/invalid
    input. Both modes share the verdict math, report shape and rc
    contract (the sample-source abstraction in slo.py)."""
    if args.live:
        if args.traces:
            print("slo: --live evaluates scraped targets; drop the "
                  "TRACE arguments (or drop --live)", file=sys.stderr)
            return 2
        if not args.targets:
            print("slo: --live needs at least one --targets JOB=URL",
                  file=sys.stderr)
            return 2
        try:
            report = _slo_live_report(args)
        except ValueError as exc:
            print(f"slo: {exc}", file=sys.stderr)
            return 2
    else:
        if args.targets:
            print("slo: --targets needs --live (trace mode reads "
                  "files)", file=sys.stderr)
            return 2
        if not args.traces:
            print("slo: pass TRACE files (or --live --targets ...)",
                  file=sys.stderr)
            return 2
        docs = []
        for path in args.traces:
            try:
                docs.append(slomod.load_trace(path))
            except OSError as exc:
                print(f"slo: cannot read {path}: {exc}", file=sys.stderr)
                return 2
            except ValueError as exc:
                print(f"slo: {path}: not a trace: {exc}",
                      file=sys.stderr)
                return 2
        try:
            report = slomod.evaluate(docs, scale=args.scale)
        except ValueError as exc:
            print(f"slo: {exc}", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(report.to_dict()))
    else:
        print(slomod.format_report(report))
    return 0 if report.ok else 1


def cmd_dash(args) -> int:
    """`dash`: terminal dashboard over a scrape-fed TSDB —
    per-target up, request/error rates, p99 latency, sparklines, event
    counts. Live mode redraws every --interval; --once renders one
    frame; --replay FILE renders a DETERMINISTIC frame from a dumped
    TSDB (the golden-test surface — byte-exact for a given dump)."""
    if args.replay:
        try:
            with open(args.replay, encoding="utf-8") as f:
                doc = json.load(f)
            tsdb = metricsdbmod.TSDB.load(doc)
        except OSError as exc:
            print(f"dash: cannot read {args.replay}: {exc}",
                  file=sys.stderr)
            return 2
        except ValueError as exc:
            print(f"dash: {args.replay}: {exc}", file=sys.stderr)
            return 2
        print(metricsdbmod.render_dash(tsdb, window_s=args.window))
        return 0
    if not args.targets:
        print("dash: pass --targets JOB=URL (repeatable) or --replay "
              "FILE", file=sys.stderr)
        return 2
    tsdb = metricsdbmod.TSDB()
    try:
        # ValueError covers bad JOB=URL specs AND duplicate job names
        # (the manager's constructor check) — both are rc-2 bad input
        manager = metricsdbmod.ScrapeManager(
            _parse_targets(args.targets), tsdb,
            interval_s=args.interval, timeout_s=args.scrape_timeout)
    except ValueError as exc:
        print(f"dash: {exc}", file=sys.stderr)
        return 2
    try:
        if args.once:
            # two scrapes one short gap apart: a single snapshot has no
            # deltas, and a rate-free dashboard answers nothing
            manager.scrape_once()
            time.sleep(min(0.5, args.interval))
            manager.scrape_once()
            print(metricsdbmod.render_dash(tsdb, window_s=args.window))
            return 0
        manager.start()
        frames = 0
        while args.frames <= 0 or frames < args.frames:
            time.sleep(args.interval)
            frames += 1
            # ANSI clear + home, then one frame — a dumb-terminal
            # redraw loop, not a TUI dependency
            print("\x1b[2J\x1b[H"
                  + metricsdbmod.render_dash(tsdb, window_s=args.window),
                  flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        manager.stop()
    return 0


def cmd_verify(args) -> int:
    spec = _load_spec(args.spec)
    names = (list(verify.CHECKS) if args.config == "all"
             else [c.strip() for c in args.config.split(",") if c.strip()])
    if not names:
        # a typo'd empty list must not turn the runbook into a free pass
        print(f"--config selected no checks; known: {list(verify.CHECKS)}",
              file=sys.stderr)
        return 2
    # One snapshot per run: every check reads the same instant of cluster
    # state, and identical kubectl invocations are fetched once and shared.
    snapshot = verify.ClusterSnapshot(verify.subprocess_runner)
    try:
        results = verify.run_checks(names, spec, snapshot)
    except KeyError as exc:
        print(exc, file=sys.stderr)
        return 2
    ok = all(r.ok for r in results)
    if args.json:
        # machine-readable runbook result (CI gates, driver artifacts)
        print(json.dumps({
            "ok": ok,
            "checks": [{"name": r.name, "ok": r.ok, "detail": r.detail}
                       for r in results],
            "kubectl_calls": snapshot.fetches,
        }))
    else:
        for res in results:
            print(res.line())
        print(f"(snapshot: {snapshot.fetches} kubectl invocation(s) "
              f"served {len(results)} check(s))")
    return 0 if ok else 1

def cmd_triage(args) -> int:
    spec = _load_spec(args.spec)
    print(triage.run_triage(spec).text())
    return 0


def cmd_trace(args) -> int:
    """Trace-file tooling for the cluster-wide correlation layer:

    - ``trace merge -o OUT IN...`` assembles per-process Chrome
      traces (``apply --trace-out``, the fake apiserver's
      ``/__fake_trace``, the C++ operator's ``--trace-out``, a flight-
      recorder dump) into ONE Perfetto timeline: per-process tracks,
      epoch-aligned time axis, trace/span ids left intact for
      correlation.
    - ``trace validate FILE`` checks a trace (merged or single)
      against the Chrome trace-event schema — the CI artifact gate.
    """
    def load(path: str):
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except OSError as exc:
            print(f"trace: cannot read {path}: {exc}", file=sys.stderr)
            return None
        except ValueError as exc:
            print(f"trace: {path} is not JSON: {exc}", file=sys.stderr)
            return None

    if args.trace_cmd == "validate":
        doc = load(args.trace)
        if doc is None:
            return 2
        try:
            complete = telemetry.validate_chrome_trace(doc)
        except ValueError as exc:
            print(f"trace: {args.trace} is not a valid Chrome trace: "
                  f"{exc}", file=sys.stderr)
            return 1
        total = len(doc.get("traceEvents", []))
        print(f"trace: {args.trace} valid — {total} event(s), "
              f"{complete} complete span(s)")
        return 0

    docs = []
    for path in args.inputs:
        doc = load(path)
        if doc is None:
            return 2
        docs.append(doc)
    try:
        merged = telemetry.merge_traces(docs)
    except ValueError as exc:
        print(f"trace merge: {exc}", file=sys.stderr)
        return 1
    try:
        telemetry.write_json(args.out, merged)
    except OSError as exc:
        print(f"trace merge: cannot write {args.out}: {exc}",
              file=sys.stderr)
        return 2
    other = merged["otherData"]
    shared = other["trace_ids"]
    print(f"trace: merged {len(docs)} trace(s) "
          f"({', '.join(other['merged_from'])}) -> {args.out} "
          f"({len(merged['traceEvents'])} events"
          + (f"; shared trace ids: {', '.join(shared)}" if shared else "")
          + "); open in ui.perfetto.dev or summarize with "
          f"`python -m tpu_cluster_torch top {args.out}`")
    return 0


def cmd_top(args) -> int:
    """Per-phase / per-object breakdown of a saved rollout trace
    (`apply --trace-out`) — where the wall time went, without
    leaving the terminal."""
    try:
        with open(args.trace, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as exc:
        print(f"top: cannot read {args.trace}: {exc}", file=sys.stderr)
        return 2
    except ValueError as exc:
        print(f"top: {args.trace} is not JSON: {exc}", file=sys.stderr)
        return 2
    try:
        print(telemetry.summarize_trace(doc, limit=args.limit))
    except ValueError as exc:
        print(f"top: {exc}", file=sys.stderr)
        return 2
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpu_cluster_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    # apiserver-connection flags shared by apply/delete (the _rest_client /
    # _kubectl_mode_flags_ok pair consumes them identically)
    conn = argparse.ArgumentParser(add_help=False)
    conn.add_argument("--spec", default="")
    conn.add_argument("--apiserver", default="",
                      help="apiserver base URL (kubectl proxy: "
                           "http://127.0.0.1:8001, or https://<host>:6443); "
                           "omit to use kubectl from PATH")
    conn.add_argument("--token-file", default="")
    conn.add_argument("--ca-file", default=None)
    conn.add_argument("--insecure-skip-tls-verify", action="store_true",
                      help="allow https to an apiserver without CA "
                           "verification (DANGEROUS: exposes the bearer "
                           "token to MITM)")
    conn.add_argument("--retry-attempts", type=int, default=5,
                      help="total tries per apiserver request: 429/5xx and "
                           "transport failures are retried with jittered "
                           "exponential backoff honoring Retry-After; "
                           "other 4xx fail immediately (default 5; 1 "
                           "disables retries)")
    conn.add_argument("--retry-base", type=float, default=0.1,
                      help="first retry backoff in seconds, doubling per "
                           "attempt up to a 5s cap (default 0.1)")
    conn.add_argument("--mux", type=int, default=0, metavar="POOL",
                      help="multiplexed transport (fleet scale): route "
                           "every request through one shared pool of at "
                           "most POOL persistent connections — sockets "
                           "O(pool) instead of O(worker threads); 0 "
                           "(default) keeps the per-thread keep-alive "
                           "transport")
    conn.add_argument("--page-limit", type=int, default=0, metavar="N",
                      help="paginated LISTs (fleet scale): chase "
                           "?limit=N&continue= pages instead of one "
                           "giant LIST body — the 410-resume re-sync "
                           "stays bounded at 1000 nodes; 0 (default) = "
                           "unpaginated")

    p = sub.add_parser("render", help="render artifacts from a cluster-spec")
    p.add_argument("--spec", default="", help="cluster-spec YAML path "
                                              "(default: built-in defaults)")
    p.add_argument("--only", choices=sorted(_EXT),
                   help="print one artifact to stdout")
    p.add_argument("--out", help="write every artifact into DIR")
    p.add_argument("--multihost", type=int, default=0,
                   help="include the N-host psum and burnin Job pairs in "
                        "'jobs'")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser(
        "lint", help="static cross-object analysis of the rendered "
                     "bundle (duplicates, dangling refs, selector and "
                     "ordering integrity, GPU resource sanity, image "
                     "pins, gang shape)")
    p.add_argument("--spec", default="", help="cluster-spec YAML path "
                                              "(default: built-in defaults)")
    p.add_argument("--operator", action="store_true",
                   help="lint the operator install waves (CRD, policy CR, "
                        "bundle, controller) instead of the operand groups")
    p.add_argument("--format", choices=("table", "json"), default="table",
                   help="findings as a human table (default) or one JSON "
                        "document")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on warnings too (the default bundle "
                        "must pass this)")
    p.add_argument("--allow-external", action="append", default=[],
                   metavar="KIND[/NS]/NAME",
                   help="reference allowlisted as pre-existing on-cluster "
                        "(repeatable; '*' wildcards namespace/name, e.g. "
                        "ServiceAccount/*/default)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser(
        "apply", help="ordered, readiness-gated rollout "
                      "(helm install --wait analog)", parents=[conn])
    p.add_argument("--operator", action="store_true",
                   help="install the in-cluster operator instead of "
                        "applying operands directly")
    p.add_argument("--wait", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--stage-timeout", type=float, default=600)
    p.add_argument("--poll", type=float, default=1.0)
    p.add_argument("--parallel", action="store_true",
                   help="pipelined rollout engine (REST backend only): "
                        "shared-cache prefetch, concurrent apply within "
                        "each dependency group, skip-unchanged re-applies")
    p.add_argument("--max-inflight", type=int, default=None,
                   help="worker-pool bound for --parallel "
                        "(default 8, min 2)")
    p.add_argument("--watch", action="store_true",
                   help="event-driven readiness (REST backend only): one "
                        "?watch=1 stream per collection instead of a "
                        "LIST per poll tick; readiness fires on the "
                        "event, degrading to the poll loop on 410/denied "
                        "watches")
    p.add_argument("--apply-mode", choices=kubeapply.APPLY_MODES,
                   default="auto",
                   help="apply mechanism (REST backend): auto (default) "
                        "uses server-side apply — one apply PATCH per "
                        "object under the 'tpuctl' field manager, "
                        "force-owning the bundle's fields — and falls "
                        "back to GET+merge-PATCH for good when the "
                        "apiserver answers 415/400; ssa requires "
                        "server-side apply; merge forces the legacy path. "
                        "--resume refuses a journal recorded in a "
                        "different explicit mode")
    p.add_argument("--deadline", type=float, default=None, metavar="SECS",
                   help="whole-rollout wall-clock budget: the remaining "
                        "budget caps every per-attempt timeout, retry "
                        "backoff, CRD/readiness wait and (on the kubectl "
                        "backend) the subprocess kill timer, so a STALLED "
                        "or TRICKLING apiserver cannot make the rollout "
                        "outlive it; exhaustion fails with a typed "
                        "DeadlineExceeded naming the slowest attempts")
    p.add_argument("--hedge", type=float, default=None, metavar="SECS",
                   help="hedge threshold for idempotent reads (REST "
                        "backend): a GET/LIST attempt still unanswered "
                        "after SECS fires ONE backup attempt on a fresh "
                        "connection and the first response wins — "
                        "tail-tolerant reads ('The Tail at Scale'); "
                        "counted in tpuctl_hedges_total; mutations are "
                        "never hedged")
    p.add_argument("--allow-empty-daemonsets", action="store_true",
                   help="treat DaemonSets with no matching nodes as ready")
    p.add_argument("--journal", default="",
                   help="record rollout progress (applied objects, "
                        "converged groups) durably in PATH — the file "
                        "--resume reads after a crash/SIGKILL")
    p.add_argument("--resume", action="store_true",
                   help="with --journal: skip groups the journal already "
                        "marks converged (and re-send nothing already "
                        "applied in the interrupted group); a journal from "
                        "a different rendered bundle is discarded")
    p.add_argument("--lint", choices=("off", "warn", "error"),
                   default="warn",
                   help="pre-apply static analysis of the rendered bundle "
                        "(lint rules R01-R07): warn reports "
                        "findings and proceeds (default); error blocks "
                        "the rollout BEFORE the first apiserver request "
                        "when any error-severity finding exists")
    p.add_argument("--allow-external", action="append", default=[],
                   metavar="KIND[/NS]/NAME",
                   help="lint-gate allowlist entry for a reference that "
                        "pre-exists on-cluster (same syntax as "
                        "lint --allow-external; repeatable)")
    p.add_argument("--trace-out", default="", metavar="PATH",
                   help="write the rollout's span tree as Chrome "
                        "trace-event JSON (load in chrome://tracing or "
                        "ui.perfetto.dev): "
                        "rollout -> group -> tier -> object -> HTTP "
                        "attempt, retries/backoff as instant events. "
                        "Written even when the rollout fails")
    p.add_argument("--metrics-out", default="", metavar="PATH",
                   help="dump the rollout's metrics registry as "
                        "Prometheus text: per-verb/status request "
                        "counters, latency and time-to-ready histograms, "
                        "retry/skip/reconnect counters")
    p.add_argument("--events", action="store_true",
                   help="record operational Kubernetes Events next to "
                        "the objects the rollout touches (REST backend): "
                        "Retrying/RetryExhausted on the retry taxonomy, "
                        "DeadlineExceeded, HedgeFired, WatchResumed — "
                        "client-go-shaped aggregation + spam filter, "
                        "fail-open (a failed Event write only bumps "
                        "tpuctl_event_emit_failures_total); read them "
                        "back with `events`")
    p.add_argument("--flight-recorder", default="", metavar="PATH|off",
                   help="always-on bounded post-mortem trace (REST "
                        "backend): a ring of the last spans/retry events, "
                        "atomically rewritten as the rollout runs, so a "
                        "crashed/SIGKILL'd apply leaves a parseable dump "
                        "even without --trace-out. Default: "
                        "tpuctl-flight-<uid>.json in the system temp "
                        "dir (per-user; concurrent applies share it — "
                        "last writer wins); 'off' disables")
    p.set_defaults(fn=cmd_apply)

    p = sub.add_parser(
        "delete", help="remove everything a spec renders, reverse order "
                       "(helm uninstall analog)", parents=[conn])
    p.add_argument("--operator", action="store_true",
                   help="remove the operator install set (CRD, policy CR, "
                        "bundle, controller) instead of the operands")
    p.set_defaults(fn=cmd_delete)

    p = sub.add_parser(
        "conlint", help="concurrency lint: enforce '# guarded-by:' lock "
                        "annotations, thread-shared-state hygiene and "
                        "explicit cross-thread span parents over Python "
                        "sources (rules CL01-CL05)")
    p.add_argument("paths", nargs="*",
                   help="files/directories (default: the "
                        "tpu_cluster_torch package)")
    p.add_argument("--format", choices=("table", "json"), default="table",
                   help="findings as lines (default) or one JSON "
                        "document")
    p.set_defaults(fn=cmd_conlint)

    p = sub.add_parser(
        "pinlint", help="contract pin analyzer: diff the machine-readable "
                        "contract registry against the C++ twin accessors, "
                        "enforcer files, docs and CI greps (rules "
                        "PL01-PL06)")
    p.add_argument("--strict", action="store_true",
                   help="fail on docs/CI drift warnings too (the gate)")
    p.add_argument("--dump", action="store_true",
                   help="print the contract registry as JSON and exit")
    p.add_argument("--format", choices=("table", "json"), default="table",
                   help="findings as lines (default) or one JSON "
                        "document")
    p.add_argument("--native-root", default="",
                   help="override where native/ sources are read from "
                        "(drift tests)")
    p.set_defaults(fn=cmd_pinlint)

    p = sub.add_parser(
        "queue", help="list/describe the gang-admission queue "
                      "(admitted, queued, preempted gangs with reasons "
                      "and reserved hosts)", parents=[conn])
    p.add_argument("gang", nargs="?", default="",
                   help="describe one gang (reserved hosts + card "
                        "indices) instead of listing all")
    p.add_argument("--namespace", default="",
                   help="namespace of the gang Jobs + reservation "
                        "ConfigMap (default: the spec's GPU namespace)")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable JSON document instead of "
                        "the table")
    p.set_defaults(fn=cmd_queue)

    p = sub.add_parser(
        "admission", help="run the gang-admission control loop: "
                          "all-or-nothing arbitration of multi-host "
                          "GPU workloads with priority preemption and "
                          "drain/re-admission on host failure",
        parents=[conn])
    p.add_argument("--namespace", default="",
                   help="namespace to arbitrate (gang Jobs + reservation "
                        "ConfigMap; default: the spec's GPU namespace)")
    p.add_argument("--once", action="store_true",
                   help="one admission pass, print the summary, exit "
                        "(CI/scripting mode)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between admission passes (default 1)")
    p.add_argument("--watch", action="store_true",
                   help="event-driven mode (fleet scale): hold one "
                        "LIST+watch informer per collection (nodes + "
                        "jobs) and re-arbitrate on EVENTS instead of "
                        "LISTing the world every pass — an idle pass "
                        "issues zero apiserver reads after the initial "
                        "sync; --interval becomes the resync backstop")
    p.add_argument("--events", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="post one correlated Event per decision "
                        "transition (Admitted/Preempted/Drained/"
                        "ReAdmitted) on the gang's Job — on by default; "
                        "--no-events restores the annotation-only loop")
    p.add_argument("--trace-out", default="", metavar="PATH",
                   help="write the admission spans as Chrome trace-event "
                        "JSON")
    p.add_argument("--metrics-out", default="", metavar="PATH",
                   help="dump the admission metrics registry "
                        "(tpuctl_admissions_total, "
                        "tpuctl_preemptions_total, "
                        "tpuctl_gang_wait_seconds) as Prometheus text")
    p.add_argument("--metrics-port", type=int, default=0, metavar="N",
                   help="serve the loop's LIVE metrics registry over "
                        "HTTP on 127.0.0.1:N (/metrics, exposition "
                        "text) so the controller is a first-class "
                        "scrape target; fail-open on bind conflict (warn, "
                        "continue); 0 (default) = off")
    p.set_defaults(fn=cmd_admission)

    p = sub.add_parser(
        "maintain", help="rolling maintenance orchestration: cordon/"
                         "drain/upgrade the fleet in wave groups under "
                         "a gang disruption budget, crash-restartable "
                         "(wave state persists in a ConfigMap)")
    msub = p.add_subparsers(dest="maintain_cmd", required=True)

    def _maintain_common(mp, with_plan: bool) -> None:
        mp.add_argument("--namespace", default="",
                        help="namespace of the wave-state/reservation "
                             "ConfigMaps and gang Jobs (default: the "
                             "spec's GPU namespace)")
        if with_plan:
            mp.add_argument("--group-size", type=int, default=1,
                            help="hosts per wave group (groups never "
                                 "mix host layouts; default 1)")
            mp.add_argument("--budget", type=int, default=1,
                            help="max concurrently-drained gangs per "
                                 "host layout (default 1)")
            mp.add_argument("--min-available", type=int, default=0,
                            help="floor of host groups left fully "
                                 "schedulable per host layout "
                                 "(default 0)")
        mp.set_defaults(fn=cmd_maintain)

    mp = msub.add_parser(
        "plan", help="render the wave groups the live fleet would get "
                     "(no writes)", parents=[conn])
    mp.add_argument("--target", required=True,
                    help="stack version the wave upgrades to")
    _maintain_common(mp, with_plan=True)

    mp = msub.add_parser(
        "status", help="read the published wave state (exit 1 when no "
                       "wave was ever run)", parents=[conn])
    _maintain_common(mp, with_plan=False)

    mp = msub.add_parser(
        "run", help="drive the wave: cordon -> drain -> upgrade -> "
                    "health-gated uncordon per group, budget-gated; "
                    "resumes the published state when --target is "
                    "omitted", parents=[conn])
    mp.add_argument("--target", default="",
                    help="stack version to upgrade to (starts a fresh "
                         "plan; omit to resume the published wave)")
    mp.add_argument("--once", action="store_true",
                    help="one maintenance pass, print the summary, exit "
                         "(CI/scripting + crash-restart mode)")
    mp.add_argument("--interval", type=float, default=1.0,
                    help="seconds between passes (default 1)")
    mp.add_argument("--events", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="post one Event per wave transition "
                         "(CordonStarted/GangDrained/UpgradeApplied/"
                         "Uncordoned/WaveComplete) on the state "
                         "ConfigMap — on by default")
    _maintain_common(mp, with_plan=True)

    p = sub.add_parser(
        "autoscale", help="metrics-driven serving autoscaler: scrape "
                          "replica /metrics, window duty-cycle + queue "
                          "depth, and scale the gang-annotated serving "
                          "Jobs through admission (scale-out = new "
                          "gang, scale-in = drain-whole), "
                          "crash-restartable (state persists in a "
                          "ConfigMap)")
    asub = p.add_subparsers(dest="autoscale_cmd", required=True)

    asp = asub.add_parser(
        "status", help="read the published autoscale state (exit 1 "
                       "when the autoscaler never ran)", parents=[conn])
    asp.add_argument("--namespace", default="",
                    help="namespace of the autoscale-state ConfigMap "
                         "(default: the spec's GPU namespace)")
    asp.set_defaults(fn=cmd_autoscale)

    asp = asub.add_parser(
        "run", help="drive the metrics->replicas loop: scrape, decide "
                    "(hysteresis + cooldown, fail-open on scrape "
                    "blindness), converge the replica Jobs",
        parents=[conn])
    asp.add_argument("--namespace", default="",
                    help="namespace of the serving Jobs and the "
                         "autoscale-state ConfigMap (default: the "
                         "spec's GPU namespace)")
    asp.add_argument("--job", default="serving",
                    help="base name of the serving deployment; replica "
                         "Jobs are <job>-0..<job>-N (default: serving)")
    asp.add_argument("--accelerator", default="h100-sxm5-80gb-8",
                    help="host layout each replica gang requests, one "
                         "host a replica (default: h100-sxm5-80gb-8)")
    asp.add_argument("--targets", action="append", default=[],
                    metavar="JOB=URL",
                    help="replica metrics endpoint (repeatable): a "
                         "ServingServer's --metrics-port exposition "
                         "URL")
    asp.add_argument("--min-replicas", type=int, default=1)
    asp.add_argument("--max-replicas", type=int, default=4)
    asp.add_argument("--duty-high", type=float, default=75.0,
                    help="windowed tpu_duty_cycle_percent above which "
                         "the fleet scales out (default 75)")
    asp.add_argument("--duty-low", type=float, default=25.0,
                    help="windowed duty below which (with an idle "
                         "queue) the fleet scales in (default 25)")
    asp.add_argument("--queue-high", type=float, default=4.0,
                    help="queued requests per replica that also trigger "
                         "scale-out (default 4)")
    asp.add_argument("--window", type=float, default=30.0,
                    help="metric window seconds (default 30)")
    asp.add_argument("--cooldown", type=float, default=60.0,
                    help="wall-clock lockout after every scale "
                         "(default 60; persists across restarts)")
    asp.add_argument("--once", action="store_true",
                    help="warm-up scrapes + one pass, print the "
                         "summary, exit (CI/scripting + crash-restart "
                         "mode)")
    asp.add_argument("--scrape-passes", type=int, default=2,
                    help="scrapes before the --once decision "
                         "(default 2)")
    asp.add_argument("--scrape-interval", type=float, default=0.05,
                    help="seconds between --once warm-up scrapes "
                         "(default 0.05)")
    asp.add_argument("--interval", type=float, default=1.0,
                    help="seconds between passes (default 1)")
    asp.add_argument("--events", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="post ScaledUp/ScaledDown/ScaleBlocked Events "
                         "on the state ConfigMap — on by default")
    asp.set_defaults(fn=cmd_autoscale)

    p = sub.add_parser(
        "events", help="list or stream (--follow) the Kubernetes Events "
                       "the stack's controllers record, each row joined "
                       "with the rollout trace that caused it",
        parents=[conn])
    p.add_argument("--namespace", default="",
                   help="namespace to read Events from (default: the "
                        "spec's GPU namespace plus 'default', where "
                        "Events about cluster-scoped objects land)")
    p.add_argument("--for", dest="for_", default="",
                   metavar="[KIND/]NAME",
                   help="only Events whose involvedObject matches "
                        "(e.g. Job/gang-train, or a bare object name)")
    p.add_argument("--follow", action="store_true",
                   help="stream new/updated Events off a watch after "
                        "printing the current set")
    p.add_argument("--follow-seconds", type=float, default=0.0,
                   help="with --follow: stop streaming after this many "
                        "seconds (0 = until interrupted; the "
                        "scripting/CI bound)")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable JSON document instead of "
                        "the table (list mode only)")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser(
        "slo", help="SLO burn-rate evaluation over span-derived "
                    "samples (SRE-workbook multi-window multi-burn-rate "
                    "rules: 5m/1h page, 6h/3d warn)")
    ssub = p.add_subparsers(dest="slo_cmd", required=True)
    sp = ssub.add_parser(
        "check", help="evaluate every SLO x window pair over one or "
                      "more rollout traces; exit 1 when a budget is "
                      "burning (window pair named)")
    sp.add_argument("traces", nargs="*", metavar="TRACE",
                    help="Chrome trace JSON files (apply "
                         "--trace-out, a Telemetry.write_trace, "
                         "flight-recorder dumps); omitted in --live "
                         "mode")
    sp.add_argument("--scale", type=float, default=None,
                    help="nominal seconds represented by one trace "
                         "second (default: the 1h page window spans "
                         "the whole trace / scraped span)")
    sp.add_argument("--live", action="store_true",
                    help="evaluate over LIVE scraped counter ratios "
                         "instead of trace spans: scrape --targets "
                         "for --duration, then apply the same "
                         "multi-window rules to windowed bad/total "
                         "increases of the code-labeled request "
                         "counters (same report shape and rc "
                         "contract)")
    sp.add_argument("--targets", action="append", default=[],
                    metavar="JOB=URL",
                    help="scrape target for --live (repeatable): a "
                         "full exposition URL, e.g. "
                         "serving=http://127.0.0.1:8000/metrics or the "
                         "fake's .../__fake_metrics")
    sp.add_argument("--duration", type=float, default=2.0,
                    help="--live: how long to scrape before "
                         "evaluating (seconds, default 2)")
    sp.add_argument("--scrape-interval", type=float, default=0.25,
                    help="--live: seconds between scrapes "
                         "(default 0.25)")
    sp.add_argument("--scrape-timeout", type=float, default=2.0,
                    help="--live: whole-attempt wall per scrape "
                         "(default 2; a stalled target marks up 0 at "
                         "the wall, never blocks the loop)")
    sp.add_argument("--json", action="store_true",
                    help="one machine-readable JSON document instead "
                         "of the table")
    sp.set_defaults(fn=cmd_slo)

    p = sub.add_parser(
        "dash", help="terminal dashboard over a scrape-fed "
                     "time-series store: per-target up, request/error "
                     "rates, p99 latency sparklines, event counts")
    p.add_argument("--targets", action="append", default=[],
                   metavar="JOB=URL",
                   help="scrape target (repeatable): a serving "
                        "replica's /metrics, the fake's "
                        "/__fake_metrics, a control loop's "
                        "--metrics-port endpoint")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between scrapes/redraws (default 2)")
    p.add_argument("--window", type=float, default=60.0,
                   help="rate/quantile window in seconds (default 60)")
    p.add_argument("--once", action="store_true",
                   help="render a single frame and exit (two quick "
                        "scrapes so rates exist)")
    p.add_argument("--replay", default="", metavar="FILE",
                   help="render one DETERMINISTIC frame from a dumped "
                        "TSDB JSON snapshot instead of scraping — the "
                        "golden-test surface (implies --once)")
    p.add_argument("--frames", type=int, default=0,
                   help="live mode: stop after N frames (0 = until "
                        "interrupted; the scripting/CI bound)")
    p.add_argument("--scrape-timeout", type=float, default=2.0,
                   help="whole-attempt wall per scrape (default 2)")
    p.set_defaults(fn=cmd_dash)

    p = sub.add_parser("verify", help="run the acceptance runbook")
    p.add_argument("--spec", default="")
    p.add_argument("--config", default="all",
                   help="all | comma-separated subset of: "
                        f"{' | '.join(verify.CHECKS)}")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable JSON line instead of "
                        "PASS/FAIL lines")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("triage", help="run the troubleshooting runbook")
    p.add_argument("--spec", default="")
    p.set_defaults(fn=cmd_triage)

    p = sub.add_parser(
        "trace", help="merge per-process Chrome traces into one "
                      "Perfetto timeline, or validate one against the "
                      "trace-event schema")
    tsub = p.add_subparsers(dest="trace_cmd", required=True)
    tp = tsub.add_parser(
        "merge", help="assemble CLI + fake-apiserver + operator traces "
                      "into one timeline with per-process tracks and "
                      "shared trace ids")
    tp.add_argument("inputs", nargs="+", metavar="TRACE",
                    help="Chrome trace JSON files (apply "
                         "--trace-out, /__fake_trace captures, "
                         "tpu-operator --trace-out, flight-recorder "
                         "dumps)")
    tp.add_argument("-o", "--out", required=True, metavar="PATH",
                    help="write the merged timeline here (atomic)")
    tp.set_defaults(fn=cmd_trace)
    tp = tsub.add_parser(
        "validate", help="check a trace file against the Chrome "
                         "trace-event schema (the CI artifact gate)")
    tp.add_argument("trace", help="trace JSON to validate")
    tp.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "top", help="summarize a saved rollout trace (apply "
                    "--trace-out): per-phase totals, request counts by "
                    "verb/status, retries, slowest spans")
    p.add_argument("trace", help="Chrome trace-event JSON written by "
                                 "apply --trace-out (or "
                                 "Telemetry.write_trace)")
    p.add_argument("--limit", type=int, default=10,
                   help="how many slowest spans to show (default 10)")
    p.set_defaults(fn=cmd_top)
    return ap



def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except specmod.SpecError as exc:
        print(f"spec error: {exc}", file=sys.stderr)
        return 2
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
