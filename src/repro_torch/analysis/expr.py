"""Restricted symbolic-formula evaluation for contract declarations: the
port's own copy of ``repro.analysis.expr`` (same helpers, same
``FormulaError``).

Contract registries declare launch censuses and byte budgets as *formulas*
over named structural parameters — ``"2 + classes"``,
``"(2 * passes + 1) * n_pad * kb"`` — instead of hard-coded integers, so one
declaration covers every (n, cfg) shape and the tests and the analyzer
evaluate the SAME source of truth.  Formulas are parsed with :mod:`ast` and
evaluated against an explicit parameter mapping under a small node/function
whitelist: no attribute access, no subscripted calls, no names outside the
parameters and the helper table.  Anything else is a declaration bug and
raises ``FormulaError`` at analysis time, never at import time.
"""
from __future__ import annotations

import ast
import math
from typing import Any, Dict


class FormulaError(ValueError):
    """A contract formula failed to parse or evaluate."""


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


_HELPERS = {
    "ceil_div": ceil_div,
    "len": len,
    "sum": sum,
    "min": min,
    "max": max,
    "abs": abs,
    "int": int,
    "range": range,
    "sqrt": math.sqrt,
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.IfExp, ast.Call, ast.Name, ast.Constant, ast.List, ast.Tuple,
    ast.ListComp, ast.GeneratorExp, ast.comprehension, ast.Load,
    # operators
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.And, ast.Or, ast.Not,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
)


def _check(node: ast.AST, params: Dict[str, Any]) -> None:
    for sub in ast.walk(node):
        if not isinstance(sub, _ALLOWED_NODES):
            raise FormulaError(
                f"disallowed syntax {type(sub).__name__!r} in contract "
                f"formula")
        if isinstance(sub, ast.Call):
            if not isinstance(sub.func, ast.Name):
                raise FormulaError("only bare helper-name calls are allowed")
            if sub.func.id not in _HELPERS:
                raise FormulaError(f"unknown helper {sub.func.id!r} "
                                   f"(allowed: {sorted(_HELPERS)})")
            if sub.keywords:
                raise FormulaError("keyword arguments are not allowed")


def evaluate(formula: str, params: Dict[str, Any]) -> Any:
    """Evaluate a declaration formula against structural parameters.

    ``params`` maps bare names (``passes``, ``classes``, ``n_pad``, ...) to
    ints/floats/lists; comprehension-bound names shadow them.  Returns
    whatever the expression produces (int, float, or list — census formulas
    like ``"[1] * chunks"`` return lists).
    """
    try:
        tree = ast.parse(formula, mode="eval")
    except SyntaxError as e:
        raise FormulaError(f"unparsable contract formula {formula!r}: {e}")
    _check(tree, params)

    env = dict(_HELPERS)
    overlap = set(env) & set(params)
    if overlap:
        raise FormulaError(f"parameters shadow helpers: {sorted(overlap)}")
    env.update(params)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, float, bool)):
                raise FormulaError(
                    f"non-numeric literal {node.value!r} in formula")
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in env:
                raise FormulaError(
                    f"unknown parameter {node.id!r} in {formula!r} "
                    f"(have: {sorted(params)})")
            return env[node.id]
        if isinstance(node, ast.UnaryOp):
            v = ev(node.operand)
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return +v
            return not v
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            op = type(node.op)
            return {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                    ast.Mult: lambda: a * b, ast.Div: lambda: a / b,
                    ast.FloorDiv: lambda: a // b, ast.Mod: lambda: a % b,
                    ast.Pow: lambda: a ** b}[op]()
        if isinstance(node, ast.BoolOp):
            vals = [ev(v) for v in node.values]
            return all(vals) if isinstance(node.op, ast.And) else any(vals)
        if isinstance(node, ast.Compare):
            left = ev(node.left)
            for op, right_n in zip(node.ops, node.comparators):
                right = ev(right_n)
                ok = {ast.Eq: left == right, ast.NotEq: left != right,
                      ast.Lt: left < right, ast.LtE: left <= right,
                      ast.Gt: left > right, ast.GtE: left >= right}[type(op)]
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        if isinstance(node, ast.Call):
            return _HELPERS[node.func.id](*[ev(a) for a in node.args])
        if isinstance(node, (ast.List, ast.Tuple)):
            return [ev(e) for e in node.elts]
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            if len(node.generators) != 1:
                raise FormulaError("only single-generator comprehensions")
            gen = node.generators[0]
            if gen.is_async or not isinstance(gen.target, ast.Name):
                raise FormulaError("unsupported comprehension form")
            out = []
            saved = env.get(gen.target.id, _MISSING)
            for item in ev(gen.iter):
                env[gen.target.id] = item
                if all(ev(c) for c in gen.ifs):
                    out.append(ev(node.elt))
            if saved is _MISSING:
                env.pop(gen.target.id, None)
            else:
                env[gen.target.id] = saved
            return out
        raise FormulaError(f"unhandled node {type(node).__name__}")

    try:
        return ev(tree)
    except FormulaError:
        raise
    except Exception as e:                      # arithmetic/type errors
        raise FormulaError(f"formula {formula!r} failed to evaluate: {e}")


_MISSING = object()
