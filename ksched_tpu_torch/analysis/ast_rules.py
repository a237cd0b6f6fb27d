"""Level-1 lint: AST rules for the port's invariants.

Each rule is a function `(ctx: FileContext) -> Iterable[Violation]`
registered in `RULES`. Rules are pure AST + comment-token analysis: no
imports of the linted code, so the linter checks files that need a card
(or a C++ toolchain) to import.

Suppressions are line-level comments on the line of the flagged node:

    w = host.astype(np.int64)  # kschedlint: host-only (why)
    i = seg.long()  # kschedlint: index-only (a gather's index)
    y = risky()  # kschedlint: disable=bare-except,raw-print -- why

`host-only` and `index-only` silence only the `dtype64` rule: the first
claims that the 64-bit value never reaches a device program, the second
that it is a 64-bit INDEX operand (torch's gather, indexing and
`index_copy_` take int64 indices), never a value. `disable=` silences
the named rules. Every form should carry a rationale; an
`unregistered-program` waiver must.

The sweep and the directive audits, as in the JAX package:

- `unregistered-program`: every device-program site in the library (a
  kernel launch `lib.ksched_*_solve(` / `_probe(`, a `torch.distributed`
  collective call, the `def` of a registered plain program) carries
  `# kschedlint: program=<name>` naming a program registered in
  `program_registry.py`, or a `disable=unregistered-program` waiver
  WITH a `-- rationale`.
- `stale-waiver`: a directive that suppresses nothing (and a
  `program=` annotation attached to no site) is itself an error.
- `bad-waiver`: an unparseable directive, a `disable=` naming an
  unknown rule, or an `unregistered-program` waiver without a rationale.

Scoping:

- `dtype64` and `int32-reduce` apply to *device modules*: files under
  the library root that import `torch`. chip_smoke.py is a script.
- `raw-print` applies to library modules except CLI entry points
  (`cli.py`, `__main__.py`).
- Everything else applies to every linted file.
"""

from __future__ import annotations

import ast
import io
import os
import tokenize
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .program_registry import SITE_NAMES

#: module names whose import marks a file a device module
_TORCH_MODULES = ("torch",)

#: attribute names the `dtype64` rule flags on any base
_DTYPE64_NAMES = frozenset({"int64", "float64", "uint64"})
#: torch's aliases (`torch.long`) and casts (`x.long()`) of them
_DTYPE64_ALIASES = frozenset({"long", "double"})

#: torch constructors that must name their dtype (keyword-only in torch)
_IMPLICIT_DTYPE_FUNCS = frozenset({"zeros", "ones", "empty", "full", "arange", "tensor"})

#: reductions that promote int32 to int64 unless given `dtype=`
_REDUCE_FUNCS = frozenset({"sum", "cumsum", "prod"})

#: top-level packages the port never imports
_FOREIGN = ("jax", "jaxlib", "ksched_tpu")

#: torch.distributed calls that move data between ranks
_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "all_to_all",
    "all_to_all_single", "reduce", "send", "recv", "isend", "irecv", "scatter",
    "gather",
})


@dataclass(frozen=True)
class Violation:
    path: str  # repo-relative, forward slashes
    rule: str
    line: int
    col: int
    message: str
    line_text: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


@dataclass
class FileContext:
    path: str  # repo-relative
    source: str
    tree: ast.Module
    lines: List[str]
    comments: Dict[int, str]  # line -> comment text (without '#')
    device_bound: bool  # imports torch -> dtype64 / int32-reduce apply
    in_library: bool  # under the library package root
    is_cli: bool  # CLI entry point (print allowed)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        d = parse_directive(lineno, self.comments.get(lineno, ""))
        if d is None:
            return False
        if d.kind in ("host-only", "index-only"):
            return rule == "dtype64"
        if d.kind == "disable":
            return rule in d.rules
        return False


def _collect_comments(source: str) -> Dict[int, str]:
    comments: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string.lstrip("#").strip()
    except (tokenize.TokenError, IndentationError):  # half-written file: lint what parsed
        pass
    return comments


def _imports(tree: ast.Module, tops: Sequence[str]) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] in tops for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and node.module.split(".")[0] in tops:
                return True
    return False


def _dotted(node: ast.AST) -> str:
    """'torch.zeros' for Attribute(Name('torch'), 'zeros'); '' when not
    a plain dotted path."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _has_dtype(node: ast.Call) -> bool:
    return any(kw.arg == "dtype" or kw.arg is None for kw in node.keywords)


# ---------------------------------------------------------------------------
# dtype64: no 64-bit values in device modules
# ---------------------------------------------------------------------------


def rule_dtype64(ctx: FileContext) -> Iterable[Violation]:
    """The solves are int32 with wrap-around, bit for bit the JAX
    package's: a 64-bit value changes the arithmetic. A 64-bit index
    operand carries `# kschedlint: index-only`, a host value that never
    reaches a device program `# kschedlint: host-only`, each with a
    rationale."""
    if not (ctx.in_library and ctx.device_bound):
        return
    calls = {id(n.func) for n in ast.walk(ctx.tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute):
            name = _dotted(node) or node.attr
            flag = node.attr in _DTYPE64_NAMES or (
                node.attr in _DTYPE64_ALIASES
                and (_dotted(node.value) == "torch" or id(node) in calls))
            if flag:
                what = f"`.{node.attr}()`" if id(node) in calls and \
                    node.attr in _DTYPE64_ALIASES else f"`{name}`"
                yield Violation(
                    ctx.path, "dtype64", node.lineno, node.col_offset,
                    f"64-bit dtype {what} in a device module; use int32/float32, "
                    "or mark the line `# kschedlint: index-only` (an index "
                    "operand) or `host-only` with a rationale",
                    ctx.line_text(node.lineno),
                )
        elif isinstance(node, ast.Call):
            is_astype = isinstance(node.func, ast.Attribute) and node.func.attr in ("astype", "to")
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value in _DTYPE64_NAMES:
                    yield Violation(
                        ctx.path, "dtype64", kw.value.lineno, kw.value.col_offset,
                        f'64-bit dtype string "{kw.value.value}" in a device module',
                        ctx.line_text(kw.value.lineno),
                    )
            if is_astype and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and a0.value in _DTYPE64_NAMES:
                    yield Violation(
                        ctx.path, "dtype64", a0.lineno, a0.col_offset,
                        f'64-bit dtype string "{a0.value}" in a device module',
                        ctx.line_text(a0.lineno),
                    )


# ---------------------------------------------------------------------------
# implicit-dtype: torch tensor creation must name its dtype
# ---------------------------------------------------------------------------


def rule_implicit_dtype(ctx: FileContext) -> Iterable[Violation]:
    """`torch.zeros(n)` is float32 and `torch.arange(n)` int64 where the
    solves need int32: every torch constructor names its dtype
    (keyword-only in torch)."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr in _IMPLICIT_DTYPE_FUNCS):
            continue
        if _dotted(func.value) != "torch" or _has_dtype(node):
            continue
        yield Violation(
            ctx.path, "implicit-dtype", node.lineno, node.col_offset,
            f"`torch.{func.attr}(...)` without an explicit dtype",
            ctx.line_text(node.lineno),
        )


# ---------------------------------------------------------------------------
# int32-reduce: reductions keep int32 (the source half of no-64-bit)
# ---------------------------------------------------------------------------


def rule_int32_reduce(ctx: FileContext) -> Iterable[Violation]:
    """`torch.sum` / `cumsum` / `prod` of an int32 or bool tensor yield
    int64 unless given `dtype=`: a bit-parity break the day someone
    forgets it. Device modules name the dtype of every such reduction
    (a numpy reduction on the host is waived with
    `disable=int32-reduce -- rationale`)."""
    if not (ctx.in_library and ctx.device_bound):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute) and func.attr in _REDUCE_FUNCS):
            continue
        if _dotted(func.value) in ("np", "numpy") or _has_dtype(node):
            continue
        yield Violation(
            ctx.path, "int32-reduce", node.lineno, node.col_offset,
            f"`.{func.attr}(...)` without `dtype=` promotes int32 to int64",
            ctx.line_text(node.lineno),
        )


# ---------------------------------------------------------------------------
# foreign-import: the port stands alone
# ---------------------------------------------------------------------------


def rule_foreign_import(ctx: FileContext) -> Iterable[Violation]:
    """The port imports neither jax nor the JAX package (`ksched_tpu`),
    not even a numpy-only module of it: it keeps its own copy."""
    for node in ast.walk(ctx.tree):
        names: List[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and _dotted(node.func) in (
                "__import__", "importlib.import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        for name in names:
            if name.split(".")[0] in _FOREIGN:
                yield Violation(
                    ctx.path, "foreign-import", node.lineno, node.col_offset,
                    f"the port imports `{name}`: it must import neither jax "
                    "nor the JAX package",
                    ctx.line_text(node.lineno),
                )


# ---------------------------------------------------------------------------
# generic Python hygiene (the JAX package's rules as they are)
# ---------------------------------------------------------------------------


def rule_mutable_default(ctx: FileContext) -> Iterable[Violation]:
    """A list/dict/set default is evaluated once and shared by every
    call — state leaks across invocations."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for default in defaults:
            bad = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set")
            )
            if bad:
                name = getattr(node, "name", "<lambda>")
                yield Violation(
                    ctx.path, "mutable-default", default.lineno, default.col_offset,
                    f"mutable default argument in `{name}` is shared across calls; "
                    "default to None and materialize inside",
                    ctx.line_text(default.lineno),
                )


def rule_bare_except(ctx: FileContext) -> Iterable[Violation]:
    """`except:` catches KeyboardInterrupt/SystemExit too; name the
    exception types (or `except Exception` at the very least)."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield Violation(
                ctx.path, "bare-except", node.lineno, node.col_offset,
                "bare `except:` swallows KeyboardInterrupt/SystemExit; name the "
                "exception types",
                ctx.line_text(node.lineno),
            )


def rule_raw_print(ctx: FileContext) -> Iterable[Violation]:
    """Library code reports through `warnings`/logging/return values so
    callers and tests can capture it; `print` is for CLI entry points
    (cli.py, __main__.py) and scripts (chip_smoke.py)."""
    if not ctx.in_library or ctx.is_cli:
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "print":
            yield Violation(
                ctx.path, "raw-print", node.lineno, node.col_offset,
                "raw `print` in library code; use warnings.warn/logging so "
                "callers can capture it",
                ctx.line_text(node.lineno),
            )


# ---------------------------------------------------------------------------
# Level 3: directive parsing, the device-program sweep, waiver audits
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Directive:
    """One parsed `# kschedlint: ...` comment."""

    line: int
    kind: str  # "host-only" | "index-only" | "disable" | "program" | "unknown"
    rules: Tuple[str, ...] = ()
    program: str = ""
    has_rationale: bool = False
    text: str = ""


def parse_directive(line: int, comment: str) -> Optional[Directive]:
    marker = comment.find("kschedlint:")
    if marker < 0:
        return None
    text = comment[marker + len("kschedlint:"):].strip()
    for kind in ("host-only", "index-only"):
        if text.startswith(kind):
            rest = text[len(kind):].strip()
            return Directive(line, kind, has_rationale=bool(rest), text=text)
    if text.startswith("disable="):
        body = text[len("disable="):]
        names_part = body.split("--")[0].split("(")[0]
        names = tuple(n.strip() for n in names_part.split(",") if n.strip())
        has_rat = "--" in body and bool(body.split("--", 1)[1].strip())
        return Directive(line, "disable", rules=names, has_rationale=has_rat, text=text)
    if text.startswith("program="):
        body = text[len("program="):]
        name = body.split("--")[0].split("(")[0].strip()
        has_rat = ("--" in body and bool(body.split("--", 1)[1].strip())) or "(" in body
        return Directive(line, "program", program=name, has_rationale=has_rat, text=text)
    return Directive(line, "unknown", text=text)


def iter_directives(ctx: FileContext) -> Iterable[Directive]:
    for line in sorted(ctx.comments):
        d = parse_directive(line, ctx.comments[line])
        if d is not None:
            yield d


@dataclass(frozen=True)
class ProgramSite:
    """One device-program site: a kernel launch, a collective call, or
    the def of a plain program annotated as one."""

    line: int  # anchor: the call's or the def's first line
    end_line: int  # last line of the call, or of the def's signature
    kind: str  # "launch" | "collective" | "def"
    callee: str
    program: Optional[str] = None  # program= annotation found in the span
    program_line: Optional[int] = None
    waiver_line: Optional[int] = None  # disable=unregistered-program line


def _site_of_call(node: ast.Call) -> Optional[Tuple[str, str, int]]:
    """(kind, callee, anchor_line) when the Call launches a device
    program or moves data between ranks."""
    if not isinstance(node.func, ast.Attribute):
        return None
    callee = _dotted(node.func) or node.func.attr
    last = node.func.attr
    if last.startswith("ksched_") and (last.endswith("_solve") or last.endswith("_probe")):
        return "launch", callee, node.func.lineno
    base = _dotted(node.func.value)
    if last in _COLLECTIVES and (base == "dist" or base.endswith("torch.distributed")):
        return "collective", callee, node.func.lineno
    return None


def _span_directives(ctx: FileContext, first: int, last: int):
    program = program_line = waiver_line = None
    for ln in range(first, last + 1):
        comment = ctx.comments.get(ln)
        if not comment:
            continue
        d = parse_directive(ln, comment)
        if d is None:
            continue
        if d.kind == "program" and program is None:
            program, program_line = d.program, ln
        elif d.kind == "disable" and "unregistered-program" in d.rules \
                and waiver_line is None:
            waiver_line = ln
    return program, program_line, waiver_line


def collect_program_sites(ctx: FileContext) -> List[ProgramSite]:
    """Every device-program site, with any `program=` annotation or
    `disable=unregistered-program` waiver on the lines it spans (a
    def's: its signature)."""
    sites: List[ProgramSite] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            found = _site_of_call(node)
            if found is None:
                continue
            kind, callee, anchor = found
            end = getattr(node, "end_lineno", None) or node.lineno
            sites.append(ProgramSite(anchor, end, kind, callee,
                                     *_span_directives(ctx, node.lineno, end)))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = max(node.lineno, node.body[0].lineno - 1)
            program, program_line, waiver_line = _span_directives(ctx, node.lineno, end)
            if program is not None:
                sites.append(ProgramSite(node.lineno, end, "def", node.name,
                                         program, program_line, waiver_line))
    sites.sort(key=lambda s: (s.line, s.kind, s.callee))
    return sites


def rule_unregistered_program(ctx: FileContext) -> Iterable[Violation]:
    """The Level-3 coverage ratchet: a device program nobody registered
    is a program nobody audits — its dtypes, scatters, host reads and
    in-place updates are all unchecked. Register it in
    analysis/program_registry.py and annotate the site, or waive with a
    rationale."""
    if not ctx.in_library:
        return
    for site in collect_program_sites(ctx):
        if site.program is not None:
            if site.program in SITE_NAMES:
                continue
            yield Violation(
                ctx.path, "unregistered-program", site.program_line, 0,
                f"`program={site.program}` names no registered program — "
                "register it in ksched_tpu_torch/analysis/program_registry.py",
                ctx.line_text(site.program_line),
            )
            continue
        vline = site.waiver_line or site.line
        yield Violation(
            ctx.path, "unregistered-program", vline, 0,
            f"`{site.callee}` runs an UNREGISTERED device program (no contract "
            "audit covers it); register it in analysis/program_registry.py "
            "and annotate `# kschedlint: program=<name>`, or waive with "
            "`# kschedlint: disable=unregistered-program -- rationale`",
            ctx.line_text(vline),
        )


#: the directive-audit rules exclude themselves when re-running the
#: rule set to decide what a directive suppresses
_WAIVER_AUDIT_RULES = ("stale-waiver", "bad-waiver")


def _raw_violations(ctx: FileContext) -> List[Violation]:
    out: List[Violation] = []
    for name, fn in RULES.items():
        if name in _WAIVER_AUDIT_RULES:
            continue
        out.extend(fn(ctx))
    return out


def rule_stale_waiver(ctx: FileContext) -> Iterable[Violation]:
    """A suppression that suppresses nothing is a latent hole: the code
    it excused is gone (or was fixed), and the directive would silently
    excuse the NEXT violation someone introduces on that line. Same for
    a `program=` annotation attached to no site. Waivers only shrink."""
    directives = list(iter_directives(ctx))
    if not directives:
        return
    by_line: Dict[int, Set[str]] = {}
    for v in _raw_violations(ctx):
        by_line.setdefault(v.line, set()).add(v.rule)
    program_lines = {
        s.program_line for s in collect_program_sites(ctx)
        if s.program_line is not None
    }
    for d in directives:
        if d.kind in ("host-only", "index-only"):
            if "dtype64" not in by_line.get(d.line, ()):
                yield Violation(
                    ctx.path, "stale-waiver", d.line, 0,
                    f"`{d.kind}` waiver suppresses nothing (no dtype64 "
                    "violation on this line) — remove it",
                    ctx.line_text(d.line),
                )
        elif d.kind == "disable":
            known = [r for r in d.rules if r in RULES]
            dead = [r for r in known if r not in by_line.get(d.line, ())]
            if dead:
                yield Violation(
                    ctx.path, "stale-waiver", d.line, 0,
                    f"disable={','.join(dead)} suppresses nothing on this "
                    "line — remove the dead waiver",
                    ctx.line_text(d.line),
                )
        elif d.kind == "program":
            if d.line not in program_lines:
                yield Violation(
                    ctx.path, "stale-waiver", d.line, 0,
                    f"`program={d.program}` annotation is attached to no "
                    "kernel launch, collective or def — remove it",
                    ctx.line_text(d.line),
                )


def rule_bad_waiver(ctx: FileContext) -> Iterable[Violation]:
    """A malformed directive checks nothing — the typo'd rule name is
    the classic case."""
    for d in iter_directives(ctx):
        if d.kind == "unknown":
            yield Violation(
                ctx.path, "bad-waiver", d.line, 0,
                f"unrecognized kschedlint directive `{d.text}` (expected "
                "host-only, index-only, disable=<rules> -- rationale, or "
                "program=<name>)",
                ctx.line_text(d.line),
            )
        elif d.kind == "disable":
            unknown = [r for r in d.rules if r not in RULES]
            if not d.rules:
                yield Violation(
                    ctx.path, "bad-waiver", d.line, 0,
                    "disable= names no rules", ctx.line_text(d.line),
                )
            if unknown:
                yield Violation(
                    ctx.path, "bad-waiver", d.line, 0,
                    f"disable= names unknown rule(s) {unknown} — a typo here "
                    "would silently check nothing",
                    ctx.line_text(d.line),
                )
            if "unregistered-program" in d.rules and not d.has_rationale:
                yield Violation(
                    ctx.path, "bad-waiver", d.line, 0,
                    "an unregistered-program waiver must carry a "
                    "`-- rationale` (why is this program exempt from the "
                    "registry audit?)",
                    ctx.line_text(d.line),
                )
        elif d.kind == "program" and not d.program:
            yield Violation(
                ctx.path, "bad-waiver", d.line, 0,
                "program= names nothing", ctx.line_text(d.line),
            )


RULES: Dict[str, Callable[[FileContext], Iterable[Violation]]] = {
    "dtype64": rule_dtype64,
    "implicit-dtype": rule_implicit_dtype,
    "int32-reduce": rule_int32_reduce,
    "foreign-import": rule_foreign_import,
    "mutable-default": rule_mutable_default,
    "bare-except": rule_bare_except,
    "raw-print": rule_raw_print,
    "unregistered-program": rule_unregistered_program,
    "stale-waiver": rule_stale_waiver,
    "bad-waiver": rule_bad_waiver,
}

#: package whose modules count as "library" for dtype64/raw-print
LIBRARY_ROOT = "ksched_tpu_torch"

#: library files that are CLI entry points (print allowed)
_CLI_BASENAMES = ("cli.py", "__main__.py")


def build_context(path: str, source: str) -> FileContext:
    tree = ast.parse(source, filename=path)
    norm = path.replace("\\", "/")
    in_library = norm.startswith(LIBRARY_ROOT + "/") or norm == LIBRARY_ROOT
    return FileContext(
        path=norm,
        source=source,
        tree=tree,
        lines=source.splitlines(),
        comments=_collect_comments(source),
        device_bound=_imports(tree, _TORCH_MODULES),
        in_library=in_library,
        is_cli=norm.rsplit("/", 1)[-1] in _CLI_BASENAMES,
    )


def lint_source(path: str, source: str, rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Lint one file's source; returns unsuppressed violations, sorted.

    An unparsable file is reported as a single `syntax-error` violation
    (a clean diagnostic that fails the gate) rather than a traceback."""
    try:
        ctx = build_context(path, source)
    except SyntaxError as e:
        return [Violation(
            path.replace("\\", "/"), "syntax-error",
            e.lineno or 1, (e.offset or 1) - 1,
            f"file does not parse: {e.msg}",
            (e.text or "").rstrip("\n"),
        )]
    selected = RULES if rules is None else {r: RULES[r] for r in rules}
    out: List[Violation] = []
    for rule_fn in selected.values():
        for v in rule_fn(ctx):
            if not ctx.suppressed(v.line, v.rule):
                out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out


def lint_file(
    path: str, repo_root: str = ".", rules: Optional[Sequence[str]] = None
) -> List[Violation]:
    abs_path = path if os.path.isabs(path) else os.path.join(repo_root, path)
    with open(abs_path, "r", encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(abs_path, repo_root)
    return lint_source(rel, source, rules=rules)


def iter_py_files(paths: Sequence[str], repo_root: str = "."):
    """Expand files/directories into .py paths (repo-relative)."""
    for p in paths:
        abs_p = p if os.path.isabs(p) else os.path.join(repo_root, p)
        if os.path.isfile(abs_p):
            yield os.path.relpath(abs_p, repo_root)
            continue
        for dirpath, dirnames, filenames in os.walk(abs_p):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in ("__pycache__", ".git", ".pytest_cache", "_build")
            )
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    yield os.path.relpath(os.path.join(dirpath, fname), repo_root)


def program_coverage(paths: Sequence[str], repo_root: str = ".") -> Dict[str, object]:
    """The Level-3 coverage report over library files in `paths`: every
    site bucketed into annotated (a `program=` naming a registered
    program), waived (`disable=unregistered-program`) or unaudited, plus
    the reverse cross-check: registered site names annotated at NO site."""
    annotated: List[Dict[str, object]] = []
    waived: List[Dict[str, object]] = []
    unaudited: List[Dict[str, object]] = []
    seen_programs: Set[str] = set()
    for rel in iter_py_files(paths, repo_root):
        with open(os.path.join(repo_root, rel), "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            ctx = build_context(rel, source)
        except SyntaxError:
            continue
        if not ctx.in_library:
            continue
        for site in collect_program_sites(ctx):
            entry = {
                "path": ctx.path, "line": site.line, "kind": site.kind,
                "callee": site.callee,
            }
            if site.program is not None and site.program in SITE_NAMES:
                entry["program"] = site.program
                annotated.append(entry)
                seen_programs.add(site.program)
            elif site.waiver_line is not None:
                waived.append(entry)
            else:
                if site.program is not None:
                    entry["program"] = site.program  # names no registered spec
                unaudited.append(entry)
    unannotated = sorted(SITE_NAMES - seen_programs)
    return {
        "annotated": annotated,
        "waived": waived,
        "unaudited": unaudited,
        "unannotated_registered": unannotated,
        "sites": len(annotated) + len(waived) + len(unaudited),
    }


def lint_paths(
    paths: Sequence[str], repo_root: str = ".", rules: Optional[Sequence[str]] = None
) -> List[Violation]:
    out: List[Violation] = []
    for rel in iter_py_files(paths, repo_root):
        out.extend(lint_file(rel, repo_root, rules=rules))
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out
