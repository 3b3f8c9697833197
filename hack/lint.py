#!/usr/bin/env python
"""In-repo static checks (the golangci-lint role of the reference's CI,
hack/common.mk:95-110 — this image has no ruff/mypy/pyflakes and installs
are disallowed, so the checks are implemented on stdlib ``ast``).

Checks:
  syntax        every .py file parses (and compiles to bytecode)
  unused-import imports never referenced in the module
  bare-except   ``except:`` with no exception class
  mutable-default  def f(x=[]) / {} / set()
  fstring-noop  f-string without any placeholder
  shadow-builtin   module-level def/class named after a builtin
  debug-leftover   pdb.set_trace / breakpoint() calls

Exit status 1 if any finding; used by ``make lint``.
"""
from __future__ import annotations

import ast
import builtins
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TARGETS = ["saprobe_alac_tpu", "tests", "hack", "bench.py", "__graft_entry__.py", "examples"]

#: name -> ok-if-unused (conventional re-export / side-effect import spots).
REEXPORT_FILES = {"__init__.py"}


def iter_py_files():
    for t in TARGETS:
        p = ROOT / t
        if p.is_file():
            yield p
        else:
            yield from sorted(p.rglob("*.py"))


class Visitor(ast.NodeVisitor):
    def __init__(self, path: Path, src: str):
        self.path = path
        self.src = src
        self.findings: list[tuple[int, str]] = []
        self.imports: dict[str, int] = {}  # local name -> lineno
        self.used: set[str] = set()

    def add(self, lineno: int, msg: str):
        self.findings.append((lineno, msg))

    # --- imports ---
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            name = a.asname or a.name.split(".")[0]
            self.imports[name] = node.lineno

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.imports[a.asname or a.name] = node.lineno

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            self.used.add(node.id)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        # record the root name of dotted access
        n = node
        while isinstance(n, ast.Attribute):
            n = n.value
        if isinstance(n, ast.Name):
            self.used.add(n.id)
        self.generic_visit(node)

    # --- smells ---
    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.type is None:
            self.add(node.lineno, "bare except")
        self.generic_visit(node)

    def _check_defaults(self, node):
        for d in node.args.defaults + node.args.kw_defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                self.add(d.lineno, "mutable default argument")

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._check_defaults(node)
        if node.col_offset == 0 and hasattr(builtins, node.name):
            self.add(node.lineno, f"module-level def shadows builtin {node.name!r}")
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_JoinedStr(self, node: ast.JoinedStr):
        if not any(isinstance(v, ast.FormattedValue) for v in node.values):
            self.add(node.lineno, "f-string without placeholders")
        self.generic_visit(node)

    def visit_FormattedValue(self, node: ast.FormattedValue):
        # Format specs are themselves JoinedStr nodes (":.3f" etc.) — do not
        # run the empty-f-string check on them.
        self.visit(node.value)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id == "breakpoint":
            self.add(node.lineno, "breakpoint() left in")
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "set_trace"
            and isinstance(f.value, ast.Name)
            and f.value.id == "pdb"
        ):
            self.add(node.lineno, "pdb.set_trace left in")
        self.generic_visit(node)


def lint_file(path: Path) -> list[tuple[int, str]]:
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
        compile(src, str(path), "exec")
    except SyntaxError as e:
        return [(e.lineno or 0, f"syntax error: {e.msg}")]
    v = Visitor(path, src)
    v.visit(tree)
    v.findings = sorted(set(v.findings))
    if path.name not in REEXPORT_FILES:
        # __all__ entries and doctest-style usage count via the Name pass;
        # string-annotation usage is rare here and not worth the noise.
        exported = set()
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))
            ):
                exported |= {
                    c.value for c in node.value.elts if isinstance(c, ast.Constant)
                }
        for name, lineno in sorted(v.imports.items(), key=lambda kv: kv[1]):
            if name not in v.used and name not in exported:
                v.add(lineno, f"unused import {name!r}")
    return sorted(v.findings)


def main() -> int:
    bad = 0
    for path in iter_py_files():
        for lineno, msg in lint_file(path):
            print(f"{path.relative_to(ROOT)}:{lineno}: {msg}")
            bad += 1
    if bad:
        print(f"lint: {bad} finding(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
