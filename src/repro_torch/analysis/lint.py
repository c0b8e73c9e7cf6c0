"""AST lint: source rules a recorded run cannot see at every call site.

The port's copy of ``repro.analysis.lint``, with the three rules scoped to
the port's layers:

  R1 ``no-comparison-sort`` — the kernel modules
     (``src/repro_torch/kernels/``) never call ``sort`` / ``argsort`` /
     ``lexsort`` / ``msort`` (``torch.sort`` included): the kernel engines
     are sort-free by construction, and a smuggled sort would pass every
     parity test while voiding the paper's claim.  ``kernels/ref.py`` is
     the declared oracle and is allowlisted.
  R2 ``no-global-prng`` — ``src/repro_torch/data/`` threads explicit
     generators: no module-level ``np.random.<draw>`` or
     ``random.<draw>`` (the constructors are the sanctioned spellings),
     no draw from torch's global generator (``torch.rand*``,
     ``randperm``, ``normal``, ``bernoulli``, ``multinomial``,
     ``poisson`` without ``generator=``) and no ``torch.manual_seed`` /
     ``torch.seed``.
  R3 ``undonated-dispatch`` — a function taking alternate ping-pong buffers
     (``alt_*`` parameters) hands every one of them on to a call (its
     launch) or writes it in place, and never allocates a same-shaped twin
     of a ``src_*`` / ``alt_*`` argument (``empty_like``, ``zeros_like``,
     ``ones_like``, ``full_like``, ``rand*_like``, ``.clone()``,
     ``.new_*``): the silent-copy bug the in-place audit catches on a run,
     caught here at the source.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import List, Sequence

SORT_NAMES = frozenset({"sort", "argsort", "lexsort", "sort_complex",
                        "msort"})
PRNG_OK = frozenset({"default_rng", "Generator", "SeedSequence",
                     "BitGenerator", "PCG64", "Philox", "RandomState"})
_PRNG_MODULES = ("np.random", "numpy.random", "random")
#: torch's draws from its global generator unless given ``generator=``
TORCH_DRAWS = frozenset({"rand", "randn", "randint", "rand_like",
                         "randn_like", "randint_like", "randperm", "normal",
                         "bernoulli", "multinomial", "poisson"})
TORCH_SEEDING = frozenset({"manual_seed", "seed"})
SORT_ALLOWLIST = ("ref.py",)
#: calls that allocate a buffer shaped like their first argument
TWIN_FUNCS = frozenset({"empty_like", "zeros_like", "ones_like", "full_like",
                        "rand_like", "randn_like", "randint_like"})
TWIN_METHODS = frozenset({"clone", "new_empty", "new_zeros", "new_ones",
                          "new_full", "new_tensor"})


@dataclass
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def lint_no_comparison_sort(tree: ast.AST, path: str) -> List[LintFinding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in SORT_NAMES:
            out.append(LintFinding(
                "no-comparison-sort", path, node.lineno,
                f"call to .{node.func.attr}() in a kernel-engine module "
                f"(sort-free contract; use kernels/ref.py for oracles)"))
    return out


def lint_no_global_prng(tree: ast.AST, path: str) -> List[LintFinding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            for mod in _PRNG_MODULES:
                prefix = mod + "."
                if dotted.startswith(prefix):
                    leaf = dotted[len(prefix):].split(".")[0]
                    if leaf not in PRNG_OK:
                        out.append(LintFinding(
                            "no-global-prng", path, node.lineno,
                            f"global-PRNG call {dotted}() — thread an "
                            f"explicit np.random.Generator instead"))
            if dotted.startswith("torch."):
                leaf = dotted[len("torch."):]
                kw = {k.arg for k in node.keywords}
                if leaf in TORCH_SEEDING or (leaf in TORCH_DRAWS and
                                             "generator" not in kw):
                    out.append(LintFinding(
                        "no-global-prng", path, node.lineno,
                        f"{dotted}() uses torch's global generator — pass "
                        f"an explicit torch.Generator"))
        elif isinstance(node, ast.ImportFrom) and \
                node.module in ("numpy.random", "random"):
            bad = [a.name for a in node.names if a.name not in PRNG_OK]
            if bad:
                out.append(LintFinding(
                    "no-global-prng", path, node.lineno,
                    f"imports global-PRNG names {bad} from {node.module}"))
    return out


def _params(fn) -> List[str]:
    args = fn.args
    every = (args.posonlyargs + args.args + args.kwonlyargs +
             ([args.vararg] if args.vararg else []))
    return [a.arg for a in every]


def _is(node, name: str) -> bool:
    return isinstance(node, ast.Name) and node.id == name


def _passed_on(fn, name: str) -> bool:
    """Whether ``name`` reaches a launch or is written in place: read inside
    a call's arguments, the target of a subscript store, or the receiver of
    an in-place method (``x.copy_(...)``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            for arg in (*node.args, *(k.value for k in node.keywords)):
                if any(_is(n, name) for n in ast.walk(arg)):
                    return True
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr.endswith("_") and \
                    _is(f.value, name):
                return True
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            if any(isinstance(t, ast.Subscript) and _is(t.value, name)
                   for t in targets):
                return True
    return False


def _twin_of(node: ast.Call):
    """The name a call allocates a twin of, or None."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in TWIN_METHODS and \
            isinstance(func.value, ast.Name):
        return func.value.id
    name = func.attr if isinstance(func, ast.Attribute) else \
        func.id if isinstance(func, ast.Name) else None
    if name in TWIN_FUNCS and node.args and \
            isinstance(node.args[0], ast.Name):
        return node.args[0].id
    return None


def lint_donated_dispatch(tree: ast.AST, path: str) -> List[LintFinding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = _params(fn)
        alts = [p for p in params if p.startswith("alt_")]
        if not alts:
            continue
        buffers = set(alts) | {p for p in params if p.startswith("src_")}
        for name in alts:
            if not _passed_on(fn, name):
                out.append(LintFinding(
                    "undonated-dispatch", path, fn.lineno,
                    f"{fn.name}() takes {name} but never hands it to its "
                    f"launch — the alternate is not written in place"))
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                twin = _twin_of(node)
                if twin in buffers:
                    out.append(LintFinding(
                        "undonated-dispatch", path, node.lineno,
                        f"{fn.name}() allocates a twin of {twin} — the "
                        f"ping-pong buffer silently copies instead of "
                        f"being reused"))
    return out


_RULES = {
    "no-comparison-sort": lint_no_comparison_sort,
    "no-global-prng": lint_no_global_prng,
    "undonated-dispatch": lint_donated_dispatch,
}


def lint_source(src: str, path: str,
                rules: Sequence[str] = tuple(_RULES)) -> List[LintFinding]:
    """Lint one source string under the named rules (mutation-test entry)."""
    tree = ast.parse(src, filename=path)
    out: List[LintFinding] = []
    for rule in rules:
        out.extend(_RULES[rule](tree, path))
    return out


def lint_file(path: str, rules: Sequence[str]) -> List[LintFinding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path, rules)


def run_lint(src_root: str) -> List[LintFinding]:
    """Lint the port's layers under their scoped rules.

    ``src_root`` is the ``src/repro_torch`` package directory.  Kernel
    modules get R1 (+R3); the data layer gets R2.
    """
    out: List[LintFinding] = []
    kdir = os.path.join(src_root, "kernels")
    for name in sorted(os.listdir(kdir)):
        if not name.endswith(".py"):
            continue
        rules = ["undonated-dispatch"]
        if name not in SORT_ALLOWLIST:
            rules.append("no-comparison-sort")
        out.extend(lint_file(os.path.join(kdir, name), rules))
    ddir = os.path.join(src_root, "data")
    for name in sorted(os.listdir(ddir)):
        if name.endswith(".py"):
            out.extend(lint_file(os.path.join(ddir, name),
                                 ["no-global-prng"]))
    return out
