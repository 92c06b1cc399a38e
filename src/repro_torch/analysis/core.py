"""reprolint core: files, suppressions, violations, and the runner.

A copy of ``repro.analysis.core`` (the port imports nothing of
``repro``); with no paths it lints ``src/repro_torch``.

The suite is pure stdlib-``ast``: analyzed code is parsed, never
imported, so a broken module can't crash the linter and the linter can
run against fixture files containing deliberately-wrong registrations.

Suppression syntax (see docs/ANALYSIS.md)::

    x = time.time()  # reprolint: disable=R4 -- measurement-only timing

The rule list is comma-separated; the ``-- reason`` tail is *required*
— a suppression without a reason does not suppress anything and instead
raises an R0 (bad-suppression) violation.  A comment-only line applies
to the next source line.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*disable=(?P<rules>[A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(?P<reason>\S.*))?\s*$")

BAD_SUPPRESSION = "R0"
STALE_SUPPRESSION = "W0"


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    file: str
    line: int
    col: int
    message: str
    severity: str = "error"   # "error" gates exit code; "warning" does not

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int          # line the comment sits on
    rules: Tuple[str, ...]
    reason: Optional[str]
    comment_only: bool  # comment-only line: applies to the next line


class SourceFile:
    """One parsed source file plus its suppression comments."""

    def __init__(self, path: Path, display: str, text: str):
        import ast

        self.path = path
        self.display = display
        self.text = text
        self.tree = ast.parse(text, filename=display)
        #: every real comment, as (line, text) — rules with their own
        #: marker syntax (R7 cache-key contracts) scan these
        self.comments, self.code_lines = _scan_comments(text)
        self.suppressions: List[Suppression] = _parse_suppressions(
            self.comments, self.code_lines)
        # line -> set of suppressed rules (only reasons-present entries)
        self._by_line: Dict[int, Set[str]] = {}
        for s in self.suppressions:
            if s.reason is None:
                continue
            target = s.line + 1 if s.comment_only else s.line
            self._by_line.setdefault(target, set()).update(s.rules)

    def suppressed(self, rule: str, line: int) -> bool:
        return rule in self._by_line.get(line, ())


def _scan_comments(text: str) -> Tuple[List[Tuple[int, str]], Set[int]]:
    """Tokenize ``text`` into (comments, code_lines): every real comment
    as (line, text) — a marker inside a string literal is ignored — plus
    the set of lines carrying non-comment tokens."""
    comments: List[Tuple[int, str]] = []
    code_lines: Set[int] = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except tokenize.TokenError:
        return comments, code_lines
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            comments.append((tok.start[0], tok.string))
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                              tokenize.INDENT, tokenize.DEDENT,
                              tokenize.ENCODING, tokenize.ENDMARKER):
            for ln in range(tok.start[0], tok.end[0] + 1):
                code_lines.add(ln)
    return comments, code_lines


def _parse_suppressions(comments: List[Tuple[int, str]],
                        code_lines: Set[int]) -> List[Suppression]:
    out: List[Suppression] = []
    for line, comment in comments:
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        out.append(Suppression(line=line, rules=rules,
                               reason=m.group("reason"),
                               comment_only=line not in code_lines))
    return out


@dataclasses.dataclass
class LintResult:
    violations: List[Violation]
    suppressed: List[Violation]
    files_checked: int
    #: warning-tier findings (W0 stale suppressions): reported, never
    #: gate the exit code
    warnings: List[Violation] = dataclasses.field(default_factory=list)

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.rule] = out.get(v.rule, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> Dict:
        return {
            "files_checked": self.files_checked,
            "counts": self.counts,
            "violations": [v.to_json() for v in self.violations],
            "suppressed": [v.to_json() for v in self.suppressed],
            "warnings": [v.to_json() for v in self.warnings],
        }


def _display(path: Path) -> str:
    try:
        return str(path.resolve().relative_to(Path.cwd()))
    except ValueError:
        return str(path)


def collect_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    seen: Set[Path] = set()
    uniq: List[Path] = []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def default_context_root() -> Path:
    """The ``repro_torch`` package directory this linter ships inside —
    always parsed for contract context (registry, protocols,
    capabilities)."""
    return Path(__file__).resolve().parents[1]


def run_lint(paths: Optional[Sequence[str]] = None,
             context_root: Optional[Path] = None,
             rules: Optional[Iterable[str]] = None) -> LintResult:
    """Lint ``paths`` (files or directories; default: the repro_torch
    source tree) and return a :class:`LintResult`.

    The whole ``repro_torch`` package is always parsed for *context* (so
    rules can resolve registrations, protocols, and the capability
    table), but only violations inside ``paths`` are reported.
    """
    from repro_torch.analysis.project import ProjectModel
    from repro_torch.analysis.rules import ALL_RULES

    ctx_root = context_root or default_context_root()
    if paths:
        target_paths = [Path(p) for p in paths]
    else:
        target_paths = [ctx_root]

    target_files = collect_files(target_paths)
    target_set = {p.resolve() for p in target_files}
    ctx_files = [p for p in collect_files([ctx_root])
                 if p.resolve() not in target_set]

    sources: List[SourceFile] = []
    parse_errors: List[Violation] = []
    in_scope: Set[str] = set()
    for path in target_files + ctx_files:
        scoped = path.resolve() in target_set
        try:
            text = path.read_text()
            sf = SourceFile(path, _display(path), text)
        except SyntaxError as exc:
            if scoped:
                parse_errors.append(Violation(
                    "R0", _display(path), exc.lineno or 1, 0,
                    f"cannot parse file: {exc.msg}"))
            continue
        sources.append(sf)
        if scoped:
            in_scope.add(sf.display)

    model = ProjectModel(sources, in_scope)

    active = list(ALL_RULES)
    if rules is not None:
        wanted = set(rules)
        active = [r for r in active if r.RULE_ID in wanted]

    raw: List[Violation] = list(parse_errors)
    for rule in active:
        raw.extend(rule.check(model))
    raw.extend(_bad_suppressions(model))
    raw = list(dict.fromkeys(raw))  # dedupe identical findings, keep order

    by_file = {sf.display: sf for sf in sources}
    kept: List[Violation] = []
    suppressed: List[Violation] = []
    for v in raw:
        if v.file not in in_scope:
            continue
        sf = by_file.get(v.file)
        if sf is not None and v.rule != BAD_SUPPRESSION \
                and sf.suppressed(v.rule, v.line):
            suppressed.append(v)
        else:
            kept.append(v)
    kept.sort(key=lambda v: (v.file, v.line, v.col, v.rule))
    suppressed.sort(key=lambda v: (v.file, v.line, v.col, v.rule))
    warnings = _stale_suppressions(
        sources, in_scope, raw, {r.RULE_ID for r in active})
    return LintResult(kept, suppressed, files_checked=len(in_scope),
                      warnings=warnings)


def _stale_suppressions(sources: List[SourceFile], in_scope: Set[str],
                        raw: List[Violation],
                        active_ids: Set[str]) -> List[Violation]:
    """W0: a reasoned suppression whose rules (among those that actually
    ran) no longer fire at its target line — dead weight that hides the
    next real violation on that line."""
    fired = {(v.file, v.line, v.rule) for v in raw}
    out: List[Violation] = []
    for sf in sources:
        if sf.display not in in_scope:
            continue
        for s in sf.suppressions:
            if s.reason is None:
                continue
            checkable = [r for r in s.rules if r in active_ids]
            if not checkable:
                continue
            target = s.line + 1 if s.comment_only else s.line
            if any((sf.display, target, r) in fired for r in checkable):
                continue
            out.append(Violation(
                STALE_SUPPRESSION, sf.display, s.line, 0,
                f"stale suppression: {','.join(checkable)} no longer "
                f"fire(s) on line {target}; remove the disable comment",
                severity="warning"))
    out.sort(key=lambda v: (v.file, v.line))
    return out


def _bad_suppressions(model) -> List[Violation]:
    out: List[Violation] = []
    for sf in model.sources:
        for s in sf.suppressions:
            if s.reason is None:
                out.append(Violation(
                    BAD_SUPPRESSION, sf.display, s.line, 0,
                    "suppression is missing its required reason "
                    "(use `# reprolint: disable=RULE -- why`)"))
    return out
