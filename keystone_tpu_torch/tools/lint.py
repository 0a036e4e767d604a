#!/usr/bin/env python
"""Repo-invariant AST linter for the port (stdlib only; a tier-1 test,
``tests/test_torch_lint.py``).  Counterpart of the repo's ``tools/lint.py``:
the same ten rules and the same escape, pointed at ``keystone_tpu_torch/``
and its own registries, with the reasons given in PyTorch and CUDA terms.

The package carries cross-cutting contracts no unit test sees locally:
fault sites must be registered or they never fire, metric names must
follow the registry convention or dashboards fragment, guard-supervised
code must use monotonic clocks or watchdog math breaks under wall-clock
steps, and obs hooks must stay inert (one ``None`` check) when no
ledger is attached.  This linter pins them at the AST level, so a
violation fails the suite the commit it appears.

Rules:

- ``fault-site``   — every string-literal site passed to
  ``fault_point(...)`` / ``SiteSpec(...)`` appears in
  ``keystone_tpu_torch/faults.py``'s ``SITES`` registry (parsed from the
  AST, so the linter never imports the package, nor torch);
- ``metric-name``  — string-literal names in
  ``metrics.inc/observe/set_gauge/gauge_max/remove_gauge(...)`` (and
  ``REGISTRY.<same>``) match ``subsystem.metric_name``: lowercase,
  dot-separated, underscore words.  Per-entity fan-out (per replica,
  per site, per collective kind) rides LABELS
  (``metrics.inc("parallel.collectives", kind=k)``), never the name: an
  interpolated name (f-string, concatenation, ``.format``) or an
  underscore-delimited integer segment (``serve.replica_0_flushes``)
  mints one series per entity.  Tenant-scoped names (a ``tenant`` word
  segment) also carry a ``tenant=`` label at the record site, and
  fleet-scoped ones (a ``fleet`` word) a ``worker=`` or ``host=`` label;
- ``metric-kind``  — one metric name is one instrument kind across the
  whole tree (the static twin of ``obs.metrics.MetricKindError``);
- ``wall-clock``   — no bare ``time.time()`` inside guard-supervised
  modules (executor, recovery, blockstore, guard, durable, the stream
  loader, multihost, serve): intervals there feed deadline, watchdog,
  retry and lease math and use ``time.monotonic()``/``perf_counter()``.
  A wall timestamp that is really wanted takes a trailing
  ``# lint: allow-wall-clock``;
- ``obs-gating``   — a variable bound from ``ledger.active()`` is only
  dereferenced under an ``is not None`` guard (the inert-hook contract);
- ``host-sync``    — no host read of a device value inside a ``for`` or
  ``while`` loop of the solver modules (block_ls, block_weighted_ls,
  lbfgs, kernel_ridge): ``np.asarray(...)``, ``.tolist()``, and the
  tensor reads ``.item()``, ``.cpu()`` and ``.numpy()``.  On a CUDA
  tensor each one synchronises the stream, so the host stops queueing
  the sweep's next launches and the side-stream block copies stop
  overlapping the solve.  A deliberate read (a checkpoint copy, an
  obs-gated value) takes a trailing ``# lint: allow-host-sync``;
- ``proc-spawn``   — no direct ``multiprocessing`` import (or
  ``os.fork``/``os.forkpty`` call) outside the serve worker modules
  (``serve/wire.py``, ``serve/worker.py``, ``serve/procfleet.py``): a
  process forked after the parent made its CUDA context cannot use the
  card (CUDA refuses re-initialisation in a forked child) and inherits
  the parent's locked runtime threads, so process management is fenced
  into the modules that use the ``spawn`` start method.  A deliberate
  use with an explicit spawn or forkserver context takes a trailing
  ``# lint: allow-proc-spawn``;
- ``socket``       — no direct ``socket`` import outside the cross-host
  transport modules (``serve/net.py``, ``serve/wire.py``,
  ``serve/ingress.py``): a raw socket elsewhere bypasses the lease and
  fencing discipline and the ``serve.net.*`` fault sites.  A deliberate
  use takes a trailing ``# lint: allow-socket``;
- ``gate``         — every literal ``KEYSTONE_*`` environment read
  (``os.environ.get/[]/pop/setdefault``, ``in os.environ``,
  ``os.getenv``) names a variable registered in
  ``keystone_tpu_torch/planner/registry.py``: a gate's or knob's ``env``
  (``GATES``, ``KNOBS``) or a member of ``OPERATIONAL_ENV`` (parsed, never
  imported).  An unregistered read is a scattered gate the physical plan
  can never own.  One-off escape: ``# lint: allow-gate``;
- ``attr``         — literal keyword attribute keys at span and event emit
  sites (``ledger.span/event(...)``, the flight recorder's
  ``rec.annotate/finish/batch/batch_update/ops(...)``) are snake_case
  members of ``keystone_tpu_torch/obs/ledger.py``'s ``ATTR_VOCABULARY``: a
  typo'd key vanishes silently into the JSONL and ring streams, and every
  reader (``tools/obs_report.py``, ``tools/trace_report.py``, jq) reads
  nothing.  One-off escape: ``# lint: allow-attr``.

Escape hatch: a trailing ``# lint: allow-<rule>`` comment allowlists
one line, visibly.

The whole package is linted, ``tools/`` included: the port's tools live
inside it, emit ledger events through its ``obs`` and read its
``KEYSTONE_*`` variables, so their emit sites have readers like any other.

Usage::

    python -m keystone_tpu_torch.tools.lint [paths...]   # default: keystone_tpu_torch/

Exit status 0 = clean, 1 = violations (printed one per line), 2 = usage.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_TARGET = os.path.join(REPO_ROOT, "keystone_tpu_torch")
FAULTS_PATH = os.path.join(REPO_ROOT, "keystone_tpu_torch", "faults.py")
OBS_LEDGER_PATH = os.path.join(REPO_ROOT, "keystone_tpu_torch", "obs", "ledger.py")
PLANNER_REGISTRY_PATH = os.path.join(
    REPO_ROOT, "keystone_tpu_torch", "planner", "registry.py"
)

#: span/event attribute keys must be snake_case (and registered)
ATTR_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: ledger emit methods (receiver must look like the ledger module or a
#: bound active-ledger variable) and flight-recorder emit methods
#: (receiver must look like a recorder binding) whose literal keyword
#: names the ``attr`` rule checks against the registered vocabulary
_LEDGER_EMITS = frozenset({"span", "event"})
_LEDGER_RECEIVERS = frozenset({"ledger", "led", "_ledger"})
_RECORDER_EMITS = frozenset({"annotate", "finish", "batch", "batch_update", "ops"})
_RECORDER_RECEIVERS = frozenset({"rec", "recorder"})
#: named parameters of recorder emit methods that are API control
#: flags, not stream attributes — exempt from the vocabulary so the
#: vocabulary documents ONLY what actually appears in the stream
_RECORDER_CONTROL_KWARGS = frozenset({"only_live"})

#: registry-convention metric names: subsystem.name[.more], lowercase
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")

#: an underscore-delimited pure-integer word inside a name segment
#: (``replica_0``, ``shard_12_bytes``): an entity index baked into the
#: metric NAME — the per-replica label convention says fan-out rides
#: labels, one name per quantity (digits glued to a word — ``bf16``,
#: ``p99`` — are fine)
METRIC_INDEX_SEGMENT_RE = re.compile(r"(^|_)\d+(_|$)")

#: a tenant-scoped metric name (any ``tenant`` word in a segment:
#: ``serve.tenant_submitted``): per-tenant fan-out must ride a
#: ``tenant=`` LABEL on the same call — a tenant name baked into the
#: metric name (or a tenant-scoped series recorded without its label)
#: mints/merges series per tenant and fragments every dashboard
METRIC_TENANT_WORD_RE = re.compile(r"(^|[._])tenants?(_|$|\.)")

#: fleet-scoped metric names (``serve.fleet.apply_seconds``): series
#: aggregated from worker-shipped telemetry span every worker and host
#: in the fleet, so a write without ``worker=``/``host=`` labels merges
#: every peer into one indistinguishable series — the per-worker
#: breakdown is the entire point of shipping them
METRIC_FLEET_WORD_RE = re.compile(r"(^|[._])fleet(_|$|\.)")

#: metrics-registry write methods → instrument kind
_METRIC_KINDS = {
    "inc": "counter",
    "observe": "histogram",
    "set_gauge": "gauge",
    "gauge_max": "gauge",
    "remove_gauge": "gauge",
}

#: modules whose timing feeds deadline/watchdog/retry/backoff math —
#: wall clock steps (NTP, suspend) must not corrupt them.  Paths are
#: repo-root-relative prefixes.
SUPERVISED_PREFIXES = (
    "keystone_tpu_torch/workflow/executor.py",
    "keystone_tpu_torch/workflow/recovery.py",
    "keystone_tpu_torch/workflow/blockstore.py",
    "keystone_tpu_torch/utils/guard.py",
    "keystone_tpu_torch/utils/durable.py",
    "keystone_tpu_torch/loaders/stream.py",
    "keystone_tpu_torch/parallel/multihost.py",
    "keystone_tpu_torch/serve/",
)

#: the only modules that may touch ``multiprocessing`` directly: the
#: process-fleet worker modules, which enforce the spawn start method
#: (a child forked from a parent holding a CUDA context cannot use the
#: card).  Everything else goes through them.
PROC_SPAWN_ALLOWED = (
    "keystone_tpu_torch/serve/wire.py",
    "keystone_tpu_torch/serve/worker.py",
    "keystone_tpu_torch/serve/procfleet.py",
)

#: the only modules that may import ``socket`` directly: the transport
#: trio — ``serve/net.py`` (lease-fenced cross-host connections, fault
#: sites on every connect/send/recv), ``serve/wire.py`` (CRC-checked
#: stream framing), and ``serve/ingress.py`` (the selector-driven front
#: end: non-blocking accept/sniff/recv_into is the whole point of the
#: module, and its frames ride the wire-v2 CRC discipline).  A raw
#: socket anywhere else bypasses the lease/fencing discipline and the
#: ``serve.net.*`` chaos surface, so network use routes through them.
SOCKET_ALLOWED = (
    "keystone_tpu_torch/serve/net.py",
    "keystone_tpu_torch/serve/wire.py",
    "keystone_tpu_torch/serve/ingress.py",
)

#: solver modules whose BCD sweep and epoch loops queue launches ahead
#: of the card: an un-annotated host read inside a loop there
#: synchronises the stream every iteration, which a future edit cannot
#: see locally.  Scoped per file like the wall-clock rule.
SOLVER_SYNC_PREFIXES = (
    "keystone_tpu_torch/models/block_ls.py",
    "keystone_tpu_torch/models/block_weighted_ls.py",
    "keystone_tpu_torch/models/lbfgs.py",
    "keystone_tpu_torch/models/kernel_ridge.py",
)

#: tensor and array methods that copy a device value to the host
_TENSOR_READS = frozenset({"tolist", "item", "cpu", "numpy"})

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow-([a-z-]+)")


class Violation:
    def __init__(self, path: str, line: int, rule: str, message: str):
        self.path = path
        self.line = line
        self.rule = rule
        self.message = message

    def __str__(self):
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def load_registered_sites(faults_path: str = FAULTS_PATH) -> frozenset:
    """Parse ``SITES = {...}`` out of faults.py WITHOUT importing it —
    the linter must run in any environment, including ones where the
    package's dependencies are absent."""
    with open(faults_path) as f:
        tree = ast.parse(f.read(), filename=faults_path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "SITES":
                    if isinstance(node.value, ast.Set):
                        return frozenset(
                            e.value
                            for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                        )
    raise RuntimeError(f"could not locate SITES registry in {faults_path}")


def load_attr_vocabulary(ledger_path: str = OBS_LEDGER_PATH) -> frozenset:
    """Parse ``ATTR_VOCABULARY = {...}`` out of obs/ledger.py WITHOUT
    importing the package (the :func:`load_registered_sites`
    discipline)."""
    with open(ledger_path) as f:
        tree = ast.parse(f.read(), filename=ledger_path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "ATTR_VOCABULARY":
                    if isinstance(node.value, ast.Set):
                        return frozenset(
                            e.value
                            for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                        )
    raise RuntimeError(f"could not locate ATTR_VOCABULARY in {ledger_path}")


def load_gate_env(registry_path: str = PLANNER_REGISTRY_PATH) -> frozenset:
    """Parse the registered ``KEYSTONE_*`` environment variables out of
    ``planner/registry.py`` WITHOUT importing it: every ``"env"`` value
    in the ``GATES``/``KNOBS`` dict literals plus every member of the
    ``OPERATIONAL_ENV`` set literal."""
    with open(registry_path) as f:
        tree = ast.parse(f.read(), filename=registry_path)
    names: set = set()
    found_gates = found_ops = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id in ("GATES", "KNOBS") and isinstance(
                node.value, ast.Dict
            ):
                if t.id == "GATES":
                    found_gates = True
                for spec in node.value.values:
                    if not isinstance(spec, ast.Dict):
                        continue
                    for k, v in zip(spec.keys, spec.values):
                        if (
                            isinstance(k, ast.Constant)
                            and k.value == "env"
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)
                        ):
                            names.add(v.value)
            elif t.id == "OPERATIONAL_ENV" and isinstance(
                node.value, ast.Set
            ):
                found_ops = True
                names.update(
                    e.value
                    for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                )
    if not (found_gates and found_ops):
        raise RuntimeError(
            f"could not locate GATES/OPERATIONAL_ENV in {registry_path}"
        )
    return frozenset(names)


def _allowed(lines: List[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(lines):
        m = _ALLOW_RE.search(lines[lineno - 1])
        if m and m.group(1) == rule:
            return True
    return False


def _receiver_name(func: ast.AST) -> Optional[Tuple[str, str]]:
    """('metrics'|'REGISTRY', method) for metrics-registry write calls."""
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    v = func.value
    if isinstance(v, ast.Name) and v.id in ("metrics", "REGISTRY"):
        return v.id, attr
    # metrics.REGISTRY.remove_gauge(...) — attribute chain ending REGISTRY
    if isinstance(v, ast.Attribute) and v.attr == "REGISTRY":
        return "REGISTRY", attr
    return None


def _str_arg0(call: ast.Call) -> Optional[Tuple[str, int]]:
    if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
        call.args[0].value, str
    ):
        return call.args[0].value, call.args[0].lineno
    return None


def _is_supervised(rel_path: str) -> bool:
    rel = rel_path.replace(os.sep, "/")
    return any(rel.startswith(p) or rel == p.rstrip("/") for p in SUPERVISED_PREFIXES)


def _is_solver_sweep(rel_path: str) -> bool:
    rel = rel_path.replace(os.sep, "/")
    return any(rel.startswith(p) for p in SOLVER_SYNC_PREFIXES)


def _proc_spawn_allowed(rel_path: str) -> bool:
    rel = rel_path.replace(os.sep, "/")
    return any(rel == p for p in PROC_SPAWN_ALLOWED)


def _socket_allowed(rel_path: str) -> bool:
    rel = rel_path.replace(os.sep, "/")
    return any(rel == p for p in SOCKET_ALLOWED)


# ------------------------------------------------------------ obs gating


def _guarded_uses(func_body: List[ast.stmt], var: str) -> List[int]:
    """Line numbers of UNGUARDED dereferences of ``var`` (attribute
    access / call / subscript on it) within ``func_body``, where a
    guard is any enclosing ``if var is not None`` (use in body),
    ``if var is None`` (use in orelse), a conditional expression with
    the same test, or a preceding early exit ``if var is None:
    return/raise/continue/break`` in the same suite."""

    def test_is(node: ast.AST, op_type) -> bool:
        return (
            isinstance(node, ast.Compare)
            and isinstance(node.left, ast.Name)
            and node.left.id == var
            and len(node.ops) == 1
            and isinstance(node.ops[0], op_type)
            and len(node.comparators) == 1
            and isinstance(node.comparators[0], ast.Constant)
            and node.comparators[0].value is None
        )

    def test_guards(node: ast.AST) -> bool:
        # `var is not None`, or conjunctions containing it
        if test_is(node, ast.IsNot):
            return True
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
            return any(test_guards(v) for v in node.values)
        return False

    bad: List[int] = []

    def deref_lines(node: ast.AST) -> List[int]:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and isinstance(
                sub.value, ast.Name
            ) and sub.value.id == var:
                out.append(sub.lineno)
            elif isinstance(sub, ast.Subscript) and isinstance(
                sub.value, ast.Name
            ) and sub.value.id == var:
                out.append(sub.lineno)
        return out

    def walk_suite(suite: List[ast.stmt], guarded: bool) -> None:
        g = guarded
        for stmt in suite:
            walk_stmt(stmt, g)
            # early exit establishes the guard for the REST of the suite
            if (
                isinstance(stmt, ast.If)
                and test_is(stmt.test, ast.Is)
                and stmt.body
                and all(
                    isinstance(s, (ast.Return, ast.Raise, ast.Continue, ast.Break))
                    for s in stmt.body[-1:]
                )
            ):
                g = True

    def walk_stmt(stmt: ast.stmt, guarded: bool) -> None:
        if isinstance(stmt, ast.If):
            if test_guards(stmt.test):
                walk_suite(stmt.body, True)
                walk_suite(stmt.orelse, guarded)
                return
            if test_is(stmt.test, ast.Is):
                walk_suite(stmt.body, guarded)
                walk_suite(stmt.orelse, True)
                return
            walk_suite(stmt.body, guarded)
            walk_suite(stmt.orelse, guarded)
            for line in deref_lines(stmt.test):
                if not guarded:
                    bad.append(line)
            return
        if isinstance(stmt, (ast.For, ast.While, ast.With, ast.Try)):
            for line in _stmt_header_derefs(stmt):
                if not guarded:
                    bad.append(line)
            for suite in _stmt_suites(stmt):
                walk_suite(suite, guarded)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_suite(stmt.body, guarded)  # nested fn: same discipline
            return
        if not guarded:
            # IfExp guards inline: `x.f() if x is not None else y`
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.IfExp) and test_guards(sub.test):
                    for line in deref_lines(sub.orelse):
                        bad.append(line)
                    break
            else:
                bad.extend(deref_lines(stmt))

    def _stmt_header_derefs(stmt) -> List[int]:
        headers = []
        if isinstance(stmt, ast.For):
            headers = deref_lines(stmt.iter)
        elif isinstance(stmt, ast.While):
            headers = deref_lines(stmt.test)
        elif isinstance(stmt, ast.With):
            headers = [ln for item in stmt.items for ln in deref_lines(item)]
        return headers

    def _stmt_suites(stmt) -> List[List[ast.stmt]]:
        suites = [getattr(stmt, "body", [])]
        suites.append(getattr(stmt, "orelse", []))
        suites.append(getattr(stmt, "finalbody", []))
        for h in getattr(stmt, "handlers", []):
            suites.append(h.body)
        return [s for s in suites if s]

    walk_suite(func_body, False)
    return sorted(set(bad))


# -------------------------------------------------------------- lint core


def lint_source(
    rel_path: str,
    source: str,
    sites: frozenset,
    metric_kinds: Dict[str, Tuple[str, str, int]],
    supervised: Optional[bool] = None,
    solver_scoped: Optional[bool] = None,
    attr_vocab: Optional[frozenset] = None,
    proc_fenced: Optional[bool] = None,
    socket_fenced: Optional[bool] = None,
    gate_env: Optional[frozenset] = None,
) -> List[Violation]:
    """Lint one file's source.  ``metric_kinds`` accumulates
    name → (kind, path, line) across files for the metric-kind rule.
    ``supervised`` overrides the path-based wall-clock scoping,
    ``solver_scoped`` the host-sync scoping, ``proc_fenced`` the
    proc-spawn scoping, and ``socket_fenced`` the socket scoping
    (tests).  ``attr_vocab``: the registered span/event attribute
    vocabulary — None skips the ``attr`` rule (``lint_paths`` loads it
    from obs/ledger.py).  ``gate_env``: the registered ``KEYSTONE_*``
    env names — None skips the ``gate`` rule (``lint_paths`` loads it
    from planner/registry.py)."""
    out: List[Violation] = []
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=rel_path)
    except SyntaxError as e:
        return [Violation(rel_path, e.lineno or 0, "syntax", str(e))]
    if supervised is None:
        supervised = _is_supervised(rel_path)
    if solver_scoped is None:
        solver_scoped = _is_solver_sweep(rel_path)
    if proc_fenced is None:
        proc_fenced = not _proc_spawn_allowed(rel_path)
    if socket_fenced is None:
        socket_fenced = not _socket_allowed(rel_path)

    # ---- socket: a raw socket import outside the transport fence
    if socket_fenced:
        for node in ast.walk(tree):
            bad_line = None
            what = None
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "socket":
                        bad_line, what = node.lineno, f"import {alias.name}"
                        break
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[0] == "socket":
                    bad_line = node.lineno
                    what = f"from {node.module} import"
            if bad_line is not None and not _allowed(
                lines, bad_line, "socket"
            ):
                out.append(
                    Violation(
                        rel_path,
                        bad_line,
                        "socket",
                        f"{what} outside the cross-host transport fence "
                        "(serve/net.py, serve/wire.py, serve/ingress.py) "
                        "— a raw socket "
                        "bypasses the lease/fencing discipline and the "
                        "serve.net.* fault sites; route network use "
                        "through the net fleet (or annotate "
                        "'# lint: allow-socket' for a deliberate, "
                        "fenced use)",
                    )
                )

    # ---- proc-spawn: multiprocessing/os.fork outside the worker fence
    if proc_fenced:
        for node in ast.walk(tree):
            bad_line = None
            what = None
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "multiprocessing":
                        bad_line, what = node.lineno, f"import {alias.name}"
                        break
            elif isinstance(node, ast.ImportFrom):
                mod = (node.module or "").split(".")[0]
                if mod == "multiprocessing":
                    bad_line, what = node.lineno, f"from {node.module} import"
                elif mod == "os":
                    # `from os import fork` escapes the attribute check
                    forked = [
                        a.name
                        for a in node.names
                        if a.name in ("fork", "forkpty")
                    ]
                    if forked:
                        bad_line = node.lineno
                        what = f"from os import {', '.join(forked)}"
            elif isinstance(node, ast.Call):
                f = node.func
                # ANY <name>.fork()/<name>.forkpty() — aliased os
                # modules (`import os as _os`) must not slip the fence
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in ("fork", "forkpty")
                    and isinstance(f.value, ast.Name)
                ):
                    bad_line = node.lineno
                    what = f"{f.value.id}.{f.attr}()"
            if bad_line is not None and not _allowed(
                lines, bad_line, "proc-spawn"
            ):
                out.append(
                    Violation(
                        rel_path,
                        bad_line,
                        "proc-spawn",
                        f"{what} outside the serve worker fence "
                        "(serve/wire.py, serve/worker.py, "
                        "serve/procfleet.py) — a child forked after "
                        "the parent's CUDA context cannot use the card "
                        "and inherits locked runtime threads; route "
                        "process use through the process fleet (or "
                        "annotate "
                        "'# lint: allow-proc-spawn' for an explicit "
                        "spawn/forkserver context)",
                    )
                )

    # ---- gate: literal KEYSTONE_* env reads vs the planner registry
    if gate_env is not None:

        def _is_environ(expr: ast.AST) -> bool:
            return (
                isinstance(expr, ast.Attribute) and expr.attr == "environ"
            ) or (isinstance(expr, ast.Name) and expr.id == "environ")

        def _keystone_name(expr: ast.AST) -> Optional[Tuple[str, int]]:
            if isinstance(expr, ast.Constant) and isinstance(
                expr.value, str
            ) and expr.value.startswith("KEYSTONE_"):
                return expr.value, expr.lineno
            return None

        def _check_gate(name_line: Optional[Tuple[str, int]]) -> None:
            if name_line is None:
                return
            name, lineno = name_line
            if name in gate_env or _allowed(lines, lineno, "gate"):
                return
            out.append(
                Violation(
                    rel_path,
                    lineno,
                    "gate",
                    f"env {name!r} is not registered in the planner gate "
                    "registry (planner/registry.py GATES env / "
                    "OPERATIONAL_ENV) — an unregistered KEYSTONE_* read "
                    "is a scattered gate the physical plan can never "
                    "own; register it (or annotate '# lint: allow-gate' "
                    "for a deliberate off-registry variable)",
                )
            )

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in ("get", "setdefault", "pop")
                    and _is_environ(f.value)
                    and node.args
                ):
                    _check_gate(_keystone_name(node.args[0]))
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr == "getenv"
                    and node.args
                ):
                    _check_gate(_keystone_name(node.args[0]))
            elif isinstance(node, ast.Subscript) and _is_environ(
                node.value
            ):
                _check_gate(_keystone_name(node.slice))
            elif isinstance(node, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
            ):
                if any(_is_environ(c) for c in node.comparators):
                    _check_gate(_keystone_name(node.left))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # ---- fault-site: fault_point("site", ...) / SiteSpec("site", ...)
        callee = (
            func.id
            if isinstance(func, ast.Name)
            else func.attr
            if isinstance(func, ast.Attribute)
            else None
        )
        if callee in ("fault_point", "SiteSpec"):
            arg = _str_arg0(node)
            if arg is not None:
                site, lineno = arg
                if site not in sites and not _allowed(
                    lines, lineno, "fault-site"
                ):
                    out.append(
                        Violation(
                            rel_path,
                            lineno,
                            "fault-site",
                            f"site {site!r} is not in the faults.SITES "
                            "registry — it would never fire",
                        )
                    )
        # ---- metric-name / metric-kind
        recv = _receiver_name(func)
        if recv is not None and recv[1] in _METRIC_KINDS:
            arg = _str_arg0(node)
            if (
                arg is None
                and node.args
                and (
                    isinstance(node.args[0], (ast.JoinedStr, ast.BinOp))
                    or (
                        isinstance(node.args[0], ast.Call)
                        and isinstance(node.args[0].func, ast.Attribute)
                        and node.args[0].func.attr == "format"
                    )
                )
                and not _allowed(lines, node.args[0].lineno, "metric-name")
            ):
                # an f-string / concatenated metric name is how an
                # entity index sneaks into the NAME (one series minted
                # per replica/site/...) — fan-out must use labels
                out.append(
                    Violation(
                        rel_path,
                        node.args[0].lineno,
                        "metric-name",
                        "interpolated metric name — per-entity fan-out "
                        "must ride labels "
                        "(metrics.inc('serve.replica_flushes', "
                        "replica=i)), not name interpolation",
                    )
                )
            if arg is not None:
                mname, lineno = arg
                if not METRIC_NAME_RE.match(mname) and not _allowed(
                    lines, lineno, "metric-name"
                ):
                    out.append(
                        Violation(
                            rel_path,
                            lineno,
                            "metric-name",
                            f"metric {mname!r} does not match the "
                            "registry convention "
                            "(lowercase dotted: subsystem.metric_name)",
                        )
                    )
                elif any(
                    METRIC_INDEX_SEGMENT_RE.search(seg)
                    for seg in mname.split(".")
                ) and not _allowed(lines, lineno, "metric-name"):
                    out.append(
                        Violation(
                            rel_path,
                            lineno,
                            "metric-name",
                            f"metric {mname!r} bakes an entity index "
                            "into the name — per-replica/per-entity "
                            "fan-out must ride labels (one name per "
                            "quantity)",
                        )
                    )
                elif (
                    METRIC_TENANT_WORD_RE.search(mname)
                    and recv[1] != "remove_gauge"
                    and not any(kw.arg == "tenant" for kw in node.keywords)
                    and not _allowed(lines, lineno, "metric-name")
                ):
                    out.append(
                        Violation(
                            rel_path,
                            lineno,
                            "metric-name",
                            f"tenant-scoped metric {mname!r} recorded "
                            "without a tenant= label — per-tenant "
                            "fan-out rides {tenant=} labels, never the "
                            "metric name",
                        )
                    )
                elif (
                    METRIC_FLEET_WORD_RE.search(mname)
                    and recv[1] != "remove_gauge"
                    and not any(
                        kw.arg in ("worker", "host")
                        for kw in node.keywords
                    )
                    and not _allowed(lines, lineno, "metric-name")
                ):
                    out.append(
                        Violation(
                            rel_path,
                            lineno,
                            "metric-name",
                            f"fleet-scoped metric {mname!r} recorded "
                            "without a worker=/host= label — worker-"
                            "shipped series carry their fan-out as "
                            "{worker=,host=} labels, never the metric "
                            "name",
                        )
                    )
                kind = _METRIC_KINDS[recv[1]]
                prev = metric_kinds.get(mname)
                if prev is None:
                    metric_kinds[mname] = (kind, rel_path, lineno)
                elif prev[0] != kind and not _allowed(
                    lines, lineno, "metric-kind"
                ):
                    out.append(
                        Violation(
                            rel_path,
                            lineno,
                            "metric-kind",
                            f"metric {mname!r} used as a {kind} here but "
                            f"as a {prev[0]} at {prev[1]}:{prev[2]} — "
                            "instrument kinds are exclusive per name",
                        )
                    )
        # ---- attr: span/event attribute keys from the registered vocab
        if attr_vocab is not None and isinstance(func, ast.Attribute):
            recv = func.value
            is_emit = isinstance(recv, ast.Name) and (
                (func.attr in _LEDGER_EMITS and recv.id in _LEDGER_RECEIVERS)
                or (
                    func.attr in _RECORDER_EMITS
                    and recv.id in _RECORDER_RECEIVERS
                )
            )
            if is_emit:
                recorder_emit = func.attr in _RECORDER_EMITS
                for kw in node.keywords:
                    if kw.arg is None:  # **attrs splat: dynamic, not ours
                        continue
                    if recorder_emit and kw.arg in _RECORDER_CONTROL_KWARGS:
                        continue  # API flag, never lands in the stream
                    if (
                        ATTR_KEY_RE.match(kw.arg)
                        and kw.arg in attr_vocab
                    ) or _allowed(lines, kw.value.lineno, "attr"):
                        continue
                    out.append(
                        Violation(
                            rel_path,
                            kw.value.lineno,
                            "attr",
                            f"span/event attribute key {kw.arg!r} is not a "
                            "snake_case member of the registered vocabulary "
                            "(obs/ledger.ATTR_VOCABULARY) — a typo'd key "
                            "vanishes silently from every trace reader",
                        )
                    )
        # ---- wall-clock: time.time() in supervised modules
        if (
            supervised
            and isinstance(func, ast.Attribute)
            and func.attr == "time"
            and isinstance(func.value, ast.Name)
            and func.value.id == "time"
            and not _allowed(lines, node.lineno, "wall-clock")
        ):
            out.append(
                Violation(
                    rel_path,
                    node.lineno,
                    "wall-clock",
                    "bare time.time() in guard-supervised code; use "
                    "time.monotonic()/perf_counter() (or annotate "
                    "'# lint: allow-wall-clock' for a true timestamp)",
                )
            )

    # ---- host-sync: np.asarray / .tolist() / .item() / .cpu() / .numpy()
    # inside solver sweep loops
    if solver_scoped:
        seen_syncs: set = set()
        for loop in ast.walk(tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                sync = None
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "asarray"
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy")
                ):
                    sync = "np.asarray(...)"
                elif isinstance(f, ast.Attribute) and f.attr in _TENSOR_READS:
                    sync = f".{f.attr}()"
                if sync is None or node.lineno in seen_syncs:
                    # nested loops revisit the same call, and a chain
                    # (x.cpu().numpy()) is one read
                    continue
                seen_syncs.add(node.lineno)
                if not _allowed(lines, node.lineno, "host-sync"):
                    out.append(
                        Violation(
                            rel_path,
                            node.lineno,
                            "host-sync",
                            f"{sync} inside a solver sweep/epoch loop "
                            "reads a device value on the host, which "
                            "synchronises the CUDA stream each iteration "
                            "and stops the host queueing launches ahead "
                            "of the card; hoist it out of the loop or "
                            "annotate '# lint: allow-host-sync' for a "
                            "deliberate, obs-gated read",
                        )
                    )

    # ---- obs-gating: per function scope
    scopes: List[Tuple[List[ast.stmt], ast.AST]] = [(tree.body, tree)]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((node.body, node))
    for body, _scope in scopes:
        # variables bound from *.active() in THIS scope's direct body
        for stmt in body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "active"
            ):
                var = stmt.targets[0].id
                for lineno in _guarded_uses(body, var):
                    if lineno <= stmt.lineno:
                        continue  # a different binding earlier in the suite
                    if not _allowed(lines, lineno, "obs-gating"):
                        out.append(
                            Violation(
                                rel_path,
                                lineno,
                                "obs-gating",
                                f"{var!r} (bound from ledger.active()) is "
                                "dereferenced without an 'is not None' "
                                "guard — obs hooks must stay inert when "
                                "no ledger is attached",
                            )
                        )
    return out


def lint_paths(
    paths: List[str],
    sites: Optional[frozenset] = None,
    attr_vocab: Optional[frozenset] = None,
    gate_env: Optional[frozenset] = None,
) -> List[Violation]:
    if sites is None:
        sites = load_registered_sites()
    if attr_vocab is None:
        attr_vocab = load_attr_vocabulary()
    if gate_env is None:
        gate_env = load_gate_env()
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                files.extend(
                    os.path.join(root, n) for n in names if n.endswith(".py")
                )
        elif p.endswith(".py"):
            files.append(p)
    violations: List[Violation] = []
    metric_kinds: Dict[str, Tuple[str, str, int]] = {}
    for path in sorted(files):
        rel = os.path.relpath(path, REPO_ROOT)
        with open(path) as f:
            source = f.read()
        violations.extend(
            lint_source(
                rel,
                source,
                sites,
                metric_kinds,
                attr_vocab=attr_vocab,
                gate_env=gate_env,
            )
        )
    return violations


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 2
    paths = argv or [DEFAULT_TARGET]
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    if violations:
        print(f"lint: {len(violations)} violation(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
