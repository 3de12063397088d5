"""Concurrency lint: lock discipline in the port's threaded layers (the
twin of `repro.analysis.concurrency`, with torch's transfers).

Scanned modules (the ones that own threads + locks): serve/batching.py,
serve/live.py, core/pipeline.py, core/online.py.

Rules
-----
transfer-under-lock   a device transfer / host conversion executed while
                      holding a lock: torch.as_tensor / torch.tensor /
                      np.asarray / np.array / np.copy /
                      torch.cuda.synchronize, or the methods .cpu() /
                      .cuda() / .numpy() / .item() / .tolist() / .to(a
                      device or a dtype), inside a `with <lock>:` block,
                      OR a call to a module-local function that itself
                      performs one (one level of intra-module inlining).
                      An upload under the registry lock stalls every
                      submit() for the duration of a host-device copy.
future-under-lock     Future completion callbacks (.set_result /
                      .set_exception / .cancel / .add_done_callback /
                      .set_running_or_notify_cancel) invoked under a lock:
                      `Future.cancel` runs user callbacks synchronously, so
                      user code executes inside the critical section.
unlocked-mutation     a read-modify-write (`+=` / `-=` style AugAssign) on
                      an attribute of a class that owns a `_lock`, executed
                      outside any `with <lock>:` block in that method.
lock-order            two locks acquired nested in BOTH orders somewhere in
                      the module (the textbook deadlock shape). Lock
                      identity is the unparsed `with` expression.

Tree-wide rules (every file `astutil.iter_source_files` yields):

join-no-timeout       `x.join()` with no arguments: a `Thread.join()` that
                      can block forever on a wedged thread.
retry-no-backoff      a retry loop that spins with no delay: a `while`
                      whose body swallows exceptions with no sleep/wait
                      call anywhere in the loop, or a `for <attempt|retry>
                      in range(...)` retry loop with a try but no
                      sleep/wait. Use `core.resilience.RetryPolicy`.

The pragma escape hatch applies (`# analysis: allow(rule): reason`), e.g.
a helper documented as "caller holds the lock".
"""

from __future__ import annotations

import ast
import itertools
from typing import Optional

from repro_torch.analysis import astutil
from repro_torch.analysis.report import Report, Violation

PASS = "concurrency"

TARGET_MODULES = (
    "src/repro_torch/serve/batching.py",
    "src/repro_torch/serve/live.py",
    "src/repro_torch/core/pipeline.py",
    "src/repro_torch/core/online.py",
)

TRANSFER_CALLS = frozenset((
    "torch.as_tensor", "torch.tensor", "numpy.asarray", "numpy.array",
    "numpy.copy", "torch.cuda.synchronize",
))
# tensor methods that copy between host and card or wait for the card
TRANSFER_METHODS = frozenset(("cpu", "cuda", "numpy", "item", "tolist"))
FUTURE_METHODS = frozenset((
    "set_result", "set_exception", "cancel", "add_done_callback",
    "set_running_or_notify_cancel",
))
# `with self.<attr>:` counts as a lock acquisition when the attr looks like
# one; Condition variables wrap a lock, so they count too
LOCK_ATTR_HINTS = ("lock", "_work", "_space", "cond", "_cv", "mutex")


def _lock_name(item: ast.withitem) -> Optional[str]:
    name = astutil.dotted_name(item.context_expr)
    if name is None:
        return None
    last = name.rsplit(".", 1)[-1].lower()
    if any(h in last for h in LOCK_ATTR_HINTS):
        return name
    return None


def transfer_name(node: ast.Call,
                  imports: astutil.ImportTable) -> Optional[str]:
    """The transfer a call performs, or None: a listed function, a listed
    tensor method, or `.to(...)` given a device or a dtype (positionally
    or by keyword)."""
    full = astutil.call_full_name(node, imports)
    if full in TRANSFER_CALLS:
        return full
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in TRANSFER_METHODS:
            return f".{attr}()"
        if attr == "to" and (node.args or any(
                kw.arg in ("device", "dtype") for kw in node.keywords)):
            return ".to(...)"
    return None


def _method_calls_transfer(fn: ast.AST, imports: astutil.ImportTable) -> bool:
    return any(isinstance(node, ast.Call) and transfer_name(node, imports)
               for node in ast.walk(fn))


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel: str, imports: astutil.ImportTable,
                 heavy_local: frozenset[str], pragmas):
        self.rel = rel
        self.imports = imports
        self.heavy_local = heavy_local
        self.pragmas = pragmas
        self.out: list[Violation] = []
        self.lock_stack: list[str] = []
        self.nesting_pairs: set[tuple[str, str, int]] = set()
        self.class_stack: list[ast.ClassDef] = []
        self.lock_classes: set[str] = set()

    def emit(self, rule: str, line: int, msg: str) -> None:
        self.out.append(self.pragmas.apply(
            Violation(PASS, rule, self.rel, line, msg)))

    # ----- structure ------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_With(self, node: ast.With) -> None:
        names = [n for n in map(_lock_name, node.items) if n]
        for outer in self.lock_stack:
            for inner in names:
                if outer != inner:
                    self.nesting_pairs.add((outer, inner, node.lineno))
        self.lock_stack.extend(names)
        self.generic_visit(node)
        del self.lock_stack[len(self.lock_stack) - len(names):]

    # ----- rules ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        if self.lock_stack:
            held = self.lock_stack[-1]
            what = transfer_name(node, self.imports)
            if what:
                self.emit("transfer-under-lock", node.lineno,
                          f"{what} while holding {held}: move the "
                          "transfer/conversion outside the critical "
                          "section")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in self.heavy_local):
                self.emit("transfer-under-lock", node.lineno,
                          f".{node.func.attr}(...) under {held} does a "
                          "device transfer / host conversion internally: "
                          "hoist the call out of the lock")
            elif isinstance(node.func, ast.Name) and (
                    node.func.id in self.heavy_local):
                self.emit("transfer-under-lock", node.lineno,
                          f"{node.func.id}(...) under {held} does a device "
                          "transfer / host conversion internally: hoist "
                          "the call out of the lock")
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in FUTURE_METHODS):
                self.emit("future-under-lock", node.lineno,
                          f"Future.{node.func.attr}() under {held}: "
                          "completion callbacks run user code inside the "
                          "critical section")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if (not self.lock_stack and self.class_stack
                and self.class_stack[-1].name in self.lock_classes
                and isinstance(node.target, ast.Attribute)
                and astutil.base_name(node.target) == "self"):
            self.emit("unlocked-mutation", node.lineno,
                      f"read-modify-write of self.{node.target.attr} "
                      f"outside the lock in lock-owning class "
                      f"{self.class_stack[-1].name!r}")
        self.generic_visit(node)


def _classes_with_lock(tree: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign)
                        and any(isinstance(t, ast.Attribute)
                                and t.attr == "_lock"
                                and astutil.base_name(t) == "self"
                                for t in sub.targets)):
                    out.add(node.name)
    return out


# ------------------------------------------------------- tree-wide rules --
RETRY_VAR_HINTS = ("attempt", "retry", "retries", "tries", "trial")
SLEEP_HINTS = ("sleep", "wait", "backoff")


def _has_backoff_call(loop: ast.AST) -> bool:
    """Any call in the loop whose name smells like a delay: time.sleep,
    cond.wait, an injected `sleep(...)` parameter, `policy.backoff()`."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Call):
            name = astutil.dotted_name(node.func)
            if name is None:
                continue
            last = name.rsplit(".", 1)[-1].lower()
            if any(h in last for h in SLEEP_HINTS):
                return True
    return False


def _handler_leaves_loop(handler: ast.ExceptHandler) -> bool:
    """True if the except body always or conditionally escapes the retry
    loop (re-raise, return, break)."""
    return any(isinstance(n, (ast.Raise, ast.Return, ast.Break))
               for n in ast.walk(handler))


def _is_retry_for(node: ast.For) -> bool:
    if not (isinstance(node.iter, ast.Call)
            and astutil.dotted_name(node.iter.func) == "range"):
        return False
    if not isinstance(node.target, ast.Name):
        return False
    name = node.target.id.lower()
    return any(h in name for h in RETRY_VAR_HINTS)


class _TreeScanner(ast.NodeVisitor):
    """join-no-timeout + retry-no-backoff over one module."""

    def __init__(self, rel: str, pragmas):
        self.rel = rel
        self.pragmas = pragmas
        self.out: list[Violation] = []

    def emit(self, rule: str, line: int, msg: str) -> None:
        self.out.append(self.pragmas.apply(
            Violation(PASS, rule, self.rel, line, msg)))

    def visit_Call(self, node: ast.Call) -> None:
        # a zero-arg .join() can only be a Thread/Process-style join (the
        # str.join / os.path.join signatures require arguments)
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and not node.args and not node.keywords):
            self.emit("join-no-timeout", node.lineno,
                      f"{astutil.dotted_name(node.func) or '.join'}() has "
                      "no timeout: it blocks forever if the thread is "
                      "wedged; join with a bound and handle is_alive()")
        self.generic_visit(node)

    def _check_retry_loop(self, node) -> None:
        swallows = any(
            not _handler_leaves_loop(h) for sub in ast.walk(node)
            if isinstance(sub, ast.Try) for h in sub.handlers)
        if swallows and not _has_backoff_call(node):
            self.emit("retry-no-backoff", node.lineno,
                      "retry loop swallows exceptions with no sleep/wait "
                      "between attempts: it hot-spins on a persistent "
                      "failure; use core.resilience.RetryPolicy (bounded "
                      "attempts + seeded exponential backoff)")

    def visit_While(self, node: ast.While) -> None:
        self._check_retry_loop(node)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _is_retry_for(node):
            self._check_retry_loop(node)
        self.generic_visit(node)


def check_tree_rules(rel: str, src: str, tree: ast.AST,
                     pragmas) -> list[Violation]:
    scanner = _TreeScanner(rel, pragmas)
    scanner.visit(tree)
    return scanner.out


def check_source(rel: str, src: str, tree: ast.AST,
                 pragmas) -> list[Violation]:
    imports = astutil.ImportTable(tree)
    # one level of intra-module inlining: functions/methods that themselves
    # perform a transfer are "heavy"; calling them under a lock is flagged
    heavy = frozenset(
        fn.name for fn in ast.walk(tree)
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        and _method_calls_transfer(fn, imports))
    scanner = _Scanner(rel, imports, heavy, pragmas)
    scanner.lock_classes = _classes_with_lock(tree)
    scanner.visit(tree)
    # lock-order: both orders observed anywhere in the module
    pairs = {(a, b) for a, b, _ in scanner.nesting_pairs}
    for (a, b), (c, d) in itertools.combinations(sorted(pairs), 2):
        if (a, b) == (d, c):
            line = min(ln for x, y, ln in scanner.nesting_pairs
                       if (x, y) in ((a, b), (c, d)))
            scanner.emit("lock-order", line,
                         f"locks {a} and {b} are acquired nested in both "
                         "orders in this module: deadlock-prone; pick one "
                         "order")
    return scanner.out


def run(root: str, report: Report, pragma_cache,
        modules=TARGET_MODULES) -> None:
    n = 0
    for rel in modules:
        try:
            src, tree = astutil.parse_file(root, rel)
        except (OSError, SyntaxError):
            continue
        n += 1
        pragmas = pragma_cache.get(rel, src)
        report.extend(check_source(rel, src, tree, pragmas))
    # join-no-timeout / retry-no-backoff apply everywhere, not just the
    # lock-owning modules
    tree_n = 0
    for rel in astutil.iter_source_files(root):
        try:
            src, tree = astutil.parse_file(root, rel)
        except (OSError, SyntaxError):
            continue
        tree_n += 1
        pragmas = pragma_cache.get(rel, src)
        report.extend(check_tree_rules(rel, src, tree, pragmas))
    report.note(PASS, modules_scanned=n, tree_modules_scanned=tree_n)
