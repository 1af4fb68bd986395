"""The flash crossover on one card: the ``xla`` attention path against the
kernels (K1 forward, K2 and K3 backward) over a grid of sequence lengths,
at both head widths the kernels are built for, on the two paths whose
attention ``burnin.select_attention`` picks.

    python -m tpu_cluster_torch.kernels.crossover [--out FILE]

Widths: ``burnin.standard_config`` (d4096, f16384, h16: d_head 256) and
``burnin.bench_config`` (d2048, f131072, h16: d_head 128), vocab 8192,
weights from seed 0. Paths:

- serving: one decode iteration as ``serving.make_decode`` runs it (host
  tokens in, next ids out), bf16 parameters, the engine's 4 slots, each
  at its last position, its keys and values cached by the warm-up calls:
  "flash" is the decode-attention kernel over the cache, ``xla`` its
  plain version (K1 no longer runs on the decode path);
- training: one ``burnin.loss_and_grads``, f32 masters, batch 1, remat
  "none".

At each point (width, path, seq) the two attention modes are timed in
turns with CUDA events: ``WARMUP`` calls of each, then ``REPS`` rounds of
one call of each, the order alternating from round to round. A row holds
each mode's median and spread (the distance between its quartiles).
:func:`pick_crossover` is the rule that sets
``burnin.FLASH_CROSSOVER_SEQ`` from such rows. :func:`check_point` holds
the flash path's logits and, on the training path, its loss and
gradients against the ``xla`` path's at one sequence length.

Beside the grid, the training shapes of ``shardbench``'s arms on one
card that the grid does not hold (:func:`arm_shapes`: its dp and mp
arms, the standard width at s512 b8) are timed the same way: they are
the traffic the constant decides below s8192. They do not enter the
rule, but a loss there at or above the constant contradicts it.

:func:`run` is the whole drive, which ``main`` and ``chip_smoke.py``
both call: the correctness point of each width, one row per point, the
rule's pick beside the constant, each reported as it lands. Every point
records the kernels' launches over its calls. ``main`` then prints one
JSON line of everything (also written to ``--out``). Out-of-memory
errors are not caught: a point that cannot run is an error of the
sweep's plan.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..workloads import burnin, serving, shardbench
from . import decode_attention as da
from . import flash_attention as fa
from .compare_fwd import power_line

SEQS = (256, 512, 1024, 2048, 4096, 8192)
PATHS = ("serving", "training")
SLOTS = 4
WARMUP = 2
REPS = 5
CHECK_SEQ = 2048
# The flash path against the "xla" path, here and in chip_smoke.py.
# f32 logits: bf16 rounding differences in the attention output propagate
# through the block (the same bound as the CPU parity tests).
LOGIT_ATOL = 5e-2
# One step's loss, and its per-parameter gradients relative to the "xla"
# magnitude: the two paths round attention to bf16 at different places
# (P unnormalised against normalised), which moves gradients by ~2^-8
# relative an element: both ratios ~8e-3 on the CPU at small widths, 4e-3
# to 8.3e-3 on an H100 at s8192.
LOSS_ATOL = 2e-3
GRAD_MAX_REL = 5e-2
GRAD_MEAN_REL = 2e-2
# K1, K2, K3 and the decode attention: every flash call on the training
# path launches the first three once a layer, every flash call on the
# serving path the last once
KERNELS = (fa.flash_attention, fa.flash_attention_bwd_dkv,
           fa.flash_attention_bwd_dq, da.decode_attention)

Row = Dict[str, Any]


def widths() -> Dict[str, burnin.BurninConfig]:
    """The two reference geometries, by name: d_head 256 and 128."""
    return {"standard": burnin.standard_config(),
            "bench": burnin.bench_config()}


def path_config(width: burnin.BurninConfig, path: str, seq: int,
                attention: str, batch: Optional[int] = None
                ) -> burnin.BurninConfig:
    """``width`` as ``path`` runs it at ``seq`` with ``attention``; its
    batch is the path's (``SLOTS`` serving, 1 training) unless given."""
    if path == "serving":
        cfg = replace(width, seq=seq, batch=SLOTS, param_dtype="bf16",
                      attention=attention)
    elif path == "training":
        cfg = replace(width, seq=seq, batch=1, remat="none",
                      attention=attention)
    else:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    return cfg if batch is None else replace(cfg, batch=batch)


def arm_shapes() -> List[Tuple[str, int, int]]:
    """(width, seq, batch) of the training shapes of ``shardbench``'s arms
    on one card that the grid's training path (batch 1) does not hold:
    its dp and mp arms, the standard width at s512 b8."""
    names = {(w.d_model, w.d_ff, w.n_heads): n for n, w in widths().items()}
    out: List[Tuple[str, int, int]] = []
    for arm in shardbench.plan(1, False):
        c = arm.cfg
        shape = (names[(c.d_model, c.d_ff, c.n_heads)], c.seq, c.batch)
        if c.batch != 1 and shape not in out:
            out.append(shape)
    return out


def params_for(width: burnin.BurninConfig, path: str,
               dev: torch.device) -> Dict[str, torch.Tensor]:
    """The path's parameters (their shapes do not depend on seq)."""
    cfg = path_config(width, path, width.seq, "xla")
    return burnin.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)


def make_call(cfg: burnin.BurninConfig, path: str,
              params: Dict[str, torch.Tensor],
              dev: torch.device) -> Callable[[], Any]:
    """One decode iteration or one ``loss_and_grads`` of ``cfg``, on
    tokens drawn from seed 1."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq)).astype(np.int32)
    if path == "serving":
        decode = serving.make_decode(cfg, dev)
        pos = np.full((cfg.batch,), cfg.seq - 1, np.int32)
        return lambda: decode(params, tokens, pos)
    toks = torch.from_numpy(tokens).to(dev)
    batch = (toks, torch.roll(toks, -1, dims=1))
    return lambda: burnin.loss_and_grads(params, batch, cfg)


def spread(times: Sequence[float]) -> float:
    """The distance between the quartiles of ``times``."""
    q1, _, q3 = statistics.quantiles(times, n=4, method="inclusive")
    return q3 - q1


def time_in_turns(calls: Dict[str, Callable[[], Any]]) -> Dict[str, float]:
    """``<mode>_ms`` (median) and ``<mode>_spread`` of each call, timed in
    turns with CUDA events after ``WARMUP`` calls of each; the order of
    the calls alternates from round to round."""
    names = list(calls)
    for _ in range(WARMUP):
        for name in names:
            calls[name]()
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {name: [] for name in names}
    for i in range(REPS):
        for name in (names if i % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            calls[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    out: Dict[str, float] = {}
    for name, ts in times.items():
        out[f"{name}_ms"] = statistics.median(ts)
        out[f"{name}_spread"] = spread(ts)
    return out


def margin(row: Row) -> Tuple[float, float]:
    """(xla ms - flash ms, the larger of the two spreads) at a point."""
    return (row["xla_ms"] - row["flash_ms"],
            max(row["xla_spread"], row["flash_spread"]))


def flash_wins(row: Row) -> bool:
    """Flash is faster at the point by more than its spread."""
    diff, noise = margin(row)
    return diff > noise


def flash_loses(row: Row) -> bool:
    """Flash is slower at the point by more than its spread."""
    diff, noise = margin(row)
    return -diff > noise


def pick_crossover(rows: Sequence[Row]
                   ) -> Tuple[Optional[int], List[Tuple[str, str]]]:
    """The rule that sets ``FLASH_CROSSOVER_SEQ``: the smallest grid seq
    from which flash wins (:func:`flash_wins`) on every path and at every
    width, at that seq and at every larger one. A margin inside the
    point's spread is no win, so the seq moves up past it. Each (path,
    width) has its own smallest such seq; the largest of them is the
    pick, and the pairs that set it are returned beside it. ``(None,
    pairs)`` when some pair's largest seq is no win (the pairs without a
    crossover)."""
    groups: Dict[Tuple[str, str], List[Row]] = {}
    for row in rows:
        groups.setdefault((row["path"], row["width"]), []).append(row)
    if not groups:
        raise ValueError("no rows")
    first: Dict[Tuple[str, str], Optional[int]] = {}
    for key, group in groups.items():
        seq = None
        for row in sorted(group, key=lambda r: r["seq"], reverse=True):
            if not flash_wins(row):
                break
            seq = row["seq"]
        first[key] = seq
    missing = sorted(k for k, s in first.items() if s is None)
    if missing:
        return None, missing
    pick = max(s for s in first.values() if s is not None)
    return pick, sorted(k for k, s in first.items() if s == pick)


def contradictions(rows: Sequence[Row], constant: int) -> List[Row]:
    """The points at or above ``constant`` where flash loses to ``xla``
    by more than the spread."""
    return [r for r in rows if r["seq"] >= constant and flash_loses(r)]


def launch_counts() -> List[int]:
    """K1's, K2's, K3's and the decode attention's launch counts so
    far."""
    return [fn.launches for fn in KERNELS]


def point_launches(path: str) -> List[int]:
    """K1, K2, K3 and decode-attention launches of one point on ``path``:
    one attention layer a flash call, K1, K2 and K3 on the training path,
    the decode attention on the serving path."""
    calls = WARMUP + REPS
    training = path == "training"
    return [calls if training else 0] * 3 + [0 if training else calls]


def time_point(name: str, path: str, seq: int, batch: Optional[int],
               params: Dict[str, torch.Tensor], dev: torch.device) -> Row:
    """One row: ``xla`` and flash timed in turns at the point, and the
    kernels' launches over its calls."""
    width = widths()[name]
    calls = {att: make_call(path_config(width, path, seq, att, batch),
                            path, params, dev)
             for att in ("xla", "flash")}
    before = launch_counts()
    row: Row = {"width": name, "d_head": width.d_model // width.n_heads,
                "path": path, "seq": seq,
                "batch": path_config(width, path, seq, "xla", batch).batch,
                **time_in_turns(calls)}
    row["launches"] = [a - b for a, b in zip(launch_counts(), before)]
    row["ratio"] = row["xla_ms"] / row["flash_ms"]
    return row


def verdict(rows: Sequence[Row], arms: Sequence[Row], constant: int
            ) -> Tuple[Optional[int], List[Tuple[str, str]], List[Row]]:
    """The grid's pick and the pairs that set it (:func:`pick_crossover`
    of ``rows``), and the points of the grid and of the arms where flash
    loses at or above ``constant`` (:func:`contradictions`)."""
    pick, by = pick_crossover(rows)
    return pick, by, contradictions(list(rows) + list(arms), constant)


def sweep(dev: torch.device,
          report: Optional[Callable[[Row], None]] = None
          ) -> Tuple[List[Row], List[Row]]:
    """Every point of the grid, then every :func:`arm_shapes` point, a row
    each (``report``ed as it lands): (grid rows, arm rows)."""
    rows: List[Row] = []
    arms: List[Row] = []
    points = [(name, path, seq, None, rows) for name in widths()
              for path in PATHS for seq in SEQS]
    points += [(name, "training", seq, batch, arms)
               for name, seq, batch in arm_shapes()]
    held: Tuple[str, str] = ("", "")
    params: Dict[str, torch.Tensor] = {}
    for name, path, seq, batch, out in points:
        if (name, path) != held:
            del params
            torch.cuda.empty_cache()
            params = params_for(widths()[name], path, dev)
            held = (name, path)
        row = time_point(name, path, seq, batch, params, dev)
        out.append(row)
        if report is not None:
            report(row)
    del params
    torch.cuda.empty_cache()
    return rows, arms


def rel_errors(got: torch.Tensor, want: torch.Tensor
               ) -> Tuple[float, float, float]:
    """(max-abs, max-abs / max|want|, mean-abs / mean|want|), in f32."""
    err = (got.float() - want.float()).abs()
    mag = want.float().abs()
    max_abs = err.max().item()
    return (max_abs, max_abs / mag.max().item(),
            err.mean().item() / mag.mean().item())


def check_point(name: str, dev: torch.device) -> Dict[str, Any]:
    """At ``CHECK_SEQ`` and the width ``name``: the serving path's logits
    of both attention modes, and the training path's loss and
    per-parameter gradients, flash against ``xla``. Returns the errors,
    the kernels' launches (K1 twice, K2 and K3 once, the decode attention
    never) and ``ok``."""
    width = widths()[name]
    seq = CHECK_SEQ
    out: Dict[str, Any] = {"width": name,
                           "d_head": width.d_model // width.n_heads,
                           "seq": seq}
    before = launch_counts()
    params = params_for(width, "serving", dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(
        rng.integers(0, width.vocab, (SLOTS, seq))).to(dev)
    with torch.inference_mode():
        logits = {att: burnin.forward(
            params, tokens, path_config(width, "serving", seq, att))
            for att in ("xla", "flash")}
    out["logits_max_abs"] = (logits["flash"] - logits["xla"]).abs().max().item()
    out["logits_finite"] = bool(torch.isfinite(logits["flash"]).all())
    del params, logits
    params = params_for(width, "training", dev)
    batch = (tokens[:1], torch.roll(tokens[:1], -1, dims=1))
    loss, grads = {}, {}
    for att in ("xla", "flash"):
        loss[att], grads[att] = burnin.loss_and_grads(
            params, batch, path_config(width, "training", seq, att))
    out["loss_abs"] = abs(loss["flash"].item() - loss["xla"].item())
    out["grads"] = {p: rel_errors(grads["flash"][p], grads["xla"][p])[1:]
                    for p in grads["xla"]}
    del params, grads
    torch.cuda.empty_cache()
    out["launches"] = [a - b for a, b in zip(launch_counts(), before)]
    out["ok"] = (out["logits_finite"] and out["logits_max_abs"] <= LOGIT_ATOL
                 and out["loss_abs"] <= LOSS_ATOL
                 and all(mx <= GRAD_MAX_REL and mean <= GRAD_MEAN_REL
                         for mx, mean in out["grads"].values()))
    return out


def format_row(row: Row) -> str:
    return (f"s{row['seq']:<5d} {row['path']:8s} b{row['batch']} d_head "
            f"{row['d_head']}: xla {row['xla_ms']:9.3f} ms (spread "
            f"{row['xla_spread']:.3f}), flash {row['flash_ms']:9.3f} ms "
            f"(spread {row['flash_spread']:.3f}), xla/flash "
            f"{row['ratio']:.3f}")


def format_check(c: Dict[str, Any]) -> str:
    worst = max(c["grads"], key=lambda p: c["grads"][p][0])
    return (f"check {c['width']} s{c['seq']}: logits flash vs xla "
            f"max_abs_err {c['logits_max_abs']:.3e} (tol {LOGIT_ATOL}); "
            f"loss |diff| {c['loss_abs']:.2e} (tol {LOSS_ATOL}); largest "
            f"gradient error {worst}: max_abs/max|xla| "
            f"{c['grads'][worst][0]:.3e} (tol {GRAD_MAX_REL}), "
            f"mean_abs/mean|xla| {max(m for _, m in c['grads'].values()):.3e}"
            f" (largest; tol {GRAD_MEAN_REL}); ok {c['ok']}")


def run(dev: torch.device, smi: str,
        say: Callable[[str], None] = print) -> Dict[str, Any]:
    """The whole drive: :func:`check_point` at each width, the
    :func:`sweep`, the rule's pick and the points at or above
    ``FLASH_CROSSOVER_SEQ`` where flash loses (``against``), each line
    ``say``-ed as it lands, the rows beside ``smi`` (the card's name and
    power limit). ``launches`` sums K1's, K2's, K3's and the decode
    attention's launches by d_head; ``launches_ok`` is whether every
    point launched them as :func:`point_launches` says."""
    checks = [check_point(name, dev) for name in widths()]
    for c in checks:
        say(format_check(c))
    rows, arms = sweep(dev, report=lambda r: say(f"{format_row(r)} ({smi})"))
    constant = burnin.FLASH_CROSSOVER_SEQ
    pick, by, against = verdict(rows, arms, constant)
    why = (f"set by {by}" if pick is not None
           else f"flash does not win at the largest seq for {by}")
    say(f"the rule picks {pick} on this run ({why}); FLASH_CROSSOVER_SEQ "
        f"in the code {constant}; points at or above it where flash loses: "
        f"{len(against)} ({smi})")
    launches: Dict[int, List[int]] = {}
    for point in checks + rows + arms:
        total = launches.setdefault(point["d_head"], [0] * len(KERNELS))
        for i, n in enumerate(point["launches"]):
            total[i] += n
    launches_ok = (all(r["launches"] == point_launches(r["path"])
                       for r in rows + arms)
                   and all(c["launches"] == [2, 1, 1, 0] for c in checks))
    return {"device": smi, "checks": checks, "rows": rows, "arms": arms,
            "pick": pick, "set_by": by, "constant": constant,
            "against": against, "launches": launches,
            "launches_ok": launches_ok,
            "ok": (all(c["ok"] for c in checks) and not against
                   and launches_ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crossover")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("crossover: no CUDA device", file=sys.stderr)
        return 2
    smi = power_line()
    print(smi)
    doc = run(torch.device("cuda"), smi)
    text = json.dumps(doc)
    print(text)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
