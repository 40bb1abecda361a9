"""ozlint framework: file model, suppressions, rule registry, runner.

Port of `ozone_tpu/tools/lint/core.py`. Dependency-free (ast, re and
pathlib only): the tier-1 gate runs `python -m
ozone_tpu_torch.tools.lint --check` in a subprocess, which must finish
well under a second without importing torch or any runtime module.

Suppression grammar (per line)::

    some_call(timeout=5.0)  # ozlint: allow[deadline-propagation] -- why

- The marker must name the rule id(s) it waives and MUST carry a
  `-- reason`; a reasonless or unknown-rule marker is itself reported
  (rule id ``suppression-format``) so justifications cannot erode.
- A marker on its own comment line covers the next statement; a marker
  on a code line covers that line, and any multi-line statement whose
  span contains the marker line.
- Fixture/corpus files may carry a first-lines pragma
  ``# ozlint: path ozone_tpu_torch/client/_fixture.py`` that sets the
  EFFECTIVE path rules use for scoping, so known-bad snippets exercise
  directory-scoped rules from anywhere on disk.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional, Sequence

#: rule id for malformed/unknown suppression markers — always active
SUPPRESSION_FORMAT = "suppression-format"

_ALLOW_RE = re.compile(
    r"#\s*ozlint:\s*allow\[([^\]]*)\]\s*(?:--\s*(.*\S))?")
_PATH_PRAGMA_RE = re.compile(r"^#\s*ozlint:\s*path\s+(\S+)\s*$")
LEGACY_ALLOW = "resilience-lint: allow"
#: directory names whose contents rules scope by their path inside them
PACKAGES = ("ozone_tpu_torch", "ozone_tpu")


class LintError(Exception):
    """A file could not be analyzed (unreadable, syntax error)."""


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``render()`` is the pinned output format (tests/test_torch_lint.py
    golden test): ``path:line: rule-id: message``."""

    rule: str
    path: str
    line: int
    message: str
    #: (first, last) line of the flagged node — used only to let a
    #: suppression marker anywhere inside a multi-line statement apply
    span: tuple[int, int] = (0, 0)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


@dataclass
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str
    own_line: bool  # marker is the whole line (covers the next stmt)


class Rule:
    """Base class: subclasses set ``id``/``summary`` and implement
    ``check(src) -> iterable of Finding``. Register with ``@register``."""

    id: str = ""
    summary: str = ""
    #: the invariant's origin story, shown by --list-rules and LINT.md
    rationale: str = ""

    def check(self, src: "SourceFile") -> Iterable[Finding]:
        raise NotImplementedError


RULES: dict[str, Rule] = {}


def register(cls: type) -> type:
    inst = cls()
    assert inst.id and inst.id not in RULES, f"bad rule registration {cls}"
    RULES[inst.id] = inst
    return cls


class SourceFile:
    """Parsed view of one file handed to every rule: AST, raw lines,
    per-line suppressions, and the EFFECTIVE module path for scoping."""

    def __init__(self, text: str, path: str = "<string>",
                 display_path: Optional[str] = None):
        self.text = text
        self.path = path
        self.display_path = display_path or path
        self.lines = text.splitlines()
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:
            raise LintError(f"{self.display_path}: syntax error at "
                            f"line {e.lineno}: {e.msg}") from e
        self.effective_path = self._effective_path()
        self.suppressions: list[Suppression] = []
        self.marker_findings: list[Finding] = []
        self._collect_suppressions()
        # shared node indexes so five rules don't re-walk the tree:
        # every node once, every Call paired with its enclosing def,
        # every (Async)FunctionDef
        self.nodes: list[ast.AST] = []
        self.calls_with_fn: list[tuple[ast.Call, Optional[ast.AST]]] = []
        self.functions: list[ast.AST] = []
        self._index(self.tree, None)

    def _index(self, node: ast.AST, fn: Optional[ast.AST]) -> None:
        stack = [(node, fn)]
        nodes, calls, functions = self.nodes, self.calls_with_fn, \
            self.functions
        fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
        while stack:
            cur, cfn = stack.pop()
            nodes.append(cur)
            if isinstance(cur, fn_types):
                functions.append(cur)
                cfn = cur
            elif isinstance(cur, ast.Call):
                calls.append((cur, cfn))
            for field in cur._fields:
                v = getattr(cur, field, None)
                if isinstance(v, ast.AST):
                    stack.append((v, cfn))
                elif isinstance(v, list):
                    stack.extend((c, cfn) for c in v
                                 if isinstance(c, ast.AST))
        self._stmt_spans = self._collect_spans()

    # ----------------------------------------------------------- scoping
    def _effective_path(self) -> str:
        for raw in self.lines[:5]:
            m = _PATH_PRAGMA_RE.match(raw.strip())
            if m:
                return m.group(1)
        return self.display_path

    @property
    def module_parts(self) -> tuple[str, ...]:
        """Path segments after the last package directory
        (``ozone_tpu_torch``, or the reference's ``ozone_tpu``) in the
        effective path — ("client", "native_dn.py") — or all segments
        when the file lives outside a package."""
        parts = Path(self.effective_path).parts
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] in PACKAGES:
                return tuple(parts[i + 1:])
        return tuple(parts)

    def in_dirs(self, *dirs: str) -> bool:
        mp = self.module_parts
        return bool(mp) and mp[0] in dirs

    def is_module(self, *rel: str) -> bool:
        return self.module_parts == rel

    # ------------------------------------------------------ suppressions
    def _comment_lines(self) -> dict[int, str]:
        """Real COMMENT tokens by line (tokenize, not raw text): a
        marker quoted inside a docstring or string literal is prose,
        not a suppression — matching raw lines would make the grammar
        impossible to document in-tree."""
        import io
        import tokenize

        out: dict[int, str] = {}
        if "ozlint" not in self.text and LEGACY_ALLOW not in self.text:
            return out  # no marker anywhere: nothing to tokenize for
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            # ast.parse accepted it; a tokenizer hiccup just means no
            # suppressions are honored for the unreadable tail
            pass
        return out

    def _collect_suppressions(self) -> None:
        for i, raw in self._comment_lines().items():
            m = _ALLOW_RE.search(raw)
            if not m:
                continue
            ids = tuple(s.strip() for s in m.group(1).split(",")
                        if s.strip())
            reason = (m.group(2) or "").strip()
            # own-line = the comment IS the whole line (check the
            # original source line; `raw` is just the comment token)
            own = self.lines[i - 1].strip().startswith("#")
            bad: list[str] = []
            if not ids:
                bad.append("empty rule list")
            unknown = [r for r in ids
                       if r not in RULES and r != SUPPRESSION_FORMAT]
            if unknown:
                bad.append(f"unknown rule id(s) {', '.join(unknown)}")
            if not reason:
                bad.append("missing `-- reason`")
            if bad:
                self.marker_findings.append(Finding(
                    SUPPRESSION_FORMAT, self.display_path, i,
                    f"malformed ozlint suppression ({'; '.join(bad)}): "
                    f"expected `# ozlint: allow[rule-id] -- reason`",
                    span=(i, i)))
            # honor even a reasonless marker so the malformed-marker
            # finding is the ONE actionable signal, not a pile of three
            self.suppressions.append(Suppression(i, ids, reason, own))

    def _collect_spans(self) -> list[tuple[int, int, bool]]:
        """(first, last, is_compound) per statement — compound bodies
        are excluded from own-line marker coverage so a marker above a
        def/with/for waives only the header, never the whole body."""
        spans = []
        for n in self.nodes:
            if isinstance(n, ast.stmt):
                compound = bool(getattr(n, "body", None))
                hi = n.end_lineno or n.lineno
                if compound:
                    first_body = n.body[0].lineno if n.body else hi
                    hi = max(n.lineno, first_body - 1)
                spans.append((n.lineno, hi, compound))
        return spans

    def _next_code_line(self, after: int) -> Optional[int]:
        for i in range(after, len(self.lines)):
            s = self.lines[i].strip()
            if s and not s.startswith("#"):
                return i + 1
        return None

    def suppressed(self, f: Finding) -> bool:
        for s in self.suppressions:
            if f.rule not in s.rules:
                continue
            if s.line == f.line:
                return True
            if s.own_line and self._next_code_line(s.line) == f.line:
                return True
            lo, hi = f.span if f.span != (0, 0) else (f.line, f.line)
            if lo <= s.line <= hi:
                return True
            # own-line marker directly above a statement also covers a
            # finding anywhere in that statement — for compound
            # statements only the HEADER lines (through the line before
            # the body), so one waived def-line finding cannot silently
            # mask future violations inside the body
            if s.own_line:
                nxt = self._next_code_line(s.line)
                if nxt is not None and any(
                        a == nxt and a <= f.line <= b
                        for a, b, _comp in self._stmt_spans):
                    return True
        return False


# --------------------------------------------------------------- runner
def _iter_py_files(paths: Sequence[str]) -> Iterable[Path]:
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            for f in sorted(pp.rglob("*.py")):
                if "__pycache__" in f.parts:
                    continue
                yield f
        elif pp.suffix == ".py":
            yield pp


def _display(path: Path, root: Optional[Path]) -> str:
    if root is not None:
        try:
            return str(path.resolve().relative_to(root.resolve()))
        except ValueError:
            pass
    return str(path)


def lint_source(text: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> list[Finding]:
    """Analyze one source string; ``path`` drives rule scoping (or use
    the in-file ``# ozlint: path ...`` pragma)."""
    _ensure_rules_loaded()
    src = SourceFile(text, path=path, display_path=path)
    return _check_one(src, rules)


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[str]] = None,
               root: Optional[str] = None) -> list[Finding]:
    """Analyze files/directories; returns unsuppressed findings sorted
    by (path, line, rule). ``root`` makes display paths relative."""
    _ensure_rules_loaded()
    rootp = Path(root) if root else None
    findings: list[Finding] = []
    for f in _iter_py_files(paths):
        disp = _display(f, rootp)
        try:
            text = f.read_text()
        except OSError as e:
            raise LintError(f"{disp}: unreadable: {e}") from e
        src = SourceFile(text, path=str(f), display_path=disp)
        findings.extend(_check_one(src, rules))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))
    return findings


def _check_one(src: SourceFile,
               rules: Optional[Sequence[str]]) -> list[Finding]:
    if rules:
        unknown = [r for r in rules
                   if r not in RULES and r != SUPPRESSION_FORMAT]
        if unknown:
            raise LintError(
                f"unknown rule id(s): {', '.join(unknown)} "
                f"(see --list-rules)")
        active = [RULES[r] for r in rules if r in RULES]
    else:
        active = list(RULES.values())
    out: list[Finding] = []
    for rule in active:
        for f in rule.check(src):
            if not src.suppressed(f):
                out.append(f)
    if rules is None or SUPPRESSION_FORMAT in rules:
        out.extend(src.marker_findings)
    return out


def format_findings(findings: Sequence[Finding]) -> str:
    lines = [f.render() for f in findings]
    lines.append(f"ozlint: {len(findings)} finding"
                 f"{'' if len(findings) == 1 else 's'}")
    return "\n".join(lines)


def _ensure_rules_loaded() -> None:
    if not RULES:
        from ozone_tpu_torch.tools.lint import rules as _rules  # noqa: F401


# ------------------------------------------------- legacy marker rewrite
def rewrite_legacy_suppressions(paths: Sequence[str]) -> list[str]:
    """--fix-suppressions: convert `# resilience-lint: allow` markers to
    `# ozlint: allow[deadline-propagation] -- <reason>` in place,
    keeping any trailing text as the reason. Returns rewritten paths."""
    changed: list[str] = []
    for f in _iter_py_files(paths):
        text = f.read_text()
        if LEGACY_ALLOW not in text:
            continue
        out_lines = []
        for line in text.splitlines(keepends=True):
            if LEGACY_ALLOW in line:
                head, _, tail = line.partition("resilience-lint: allow")
                head = head.rstrip()
                if head.endswith("#"):
                    head = head[:-1].rstrip()
                reason = tail.strip(" -\n") or \
                    "migrated legacy exemption marker"
                nl = "\n" if line.endswith("\n") else ""
                line = (f"{head}  # ozlint: allow[deadline-propagation]"
                        f" -- {reason}{nl}")
            out_lines.append(line)
        f.write_text("".join(out_lines))
        changed.append(str(f))
    return changed
