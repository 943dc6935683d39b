#!/usr/bin/env python
"""Import-layering guard for the PyTorch port (``src/repro_torch``).

The port's counterpart of ``tools/check_layers.py``: it AST-scans every
module under ``src/repro_torch`` — top-level *and* function-local
imports, plus ``importlib.import_module`` calls with literal arguments —
and fails when a package imports a layer above itself.  The graph, from
the bottom up:

    errors, obs, robust,    (taxonomy, telemetry, fault harness, the
    checkpoint               numpy checkpoint layout)
    kernels                 (kernels and their plain versions)
        -> core             (plan IR + plan builders)
        -> exec             (executor pipeline + health table)
        -> dynamic, data    (plan maintenance: value updates, the delta
                             sidecar, the registry; the graph generators
                             and the mutation stream)
        -> sparse           (the user-facing operator facade)
        -> models           (graph layers over the facade)
        -> interop          (JAX <-> port state, layers included)
        -> serve            (the batching SpMM service over dynamic
                             plans, the registry and the tuner)
        -> examples         (scripts; imported by nothing)

``data`` sits beside ``dynamic``: its generators import numpy alone,
and ``mutate`` builds ``dynamic.GraphDelta`` batches (a function-local
import, as in the reference).  Nothing below ``dynamic`` imports it.

``models`` and ``interop`` sit above ``sparse`` here, as the port's
imports place them: the graph layers call the facade (the reference's
layers call its executor directly).

``kernels`` may import ``core.cost_model`` (the fringe tier selection,
as in the reference) and ``core.plan_ir`` (``unsplittable_flag``, the
tile-value check the matrix-path kernels share with ``prepare``); both
import nothing above ``errors``.

One allowance, pinned to one module and target: ``core/spmm.py``
forwards execution names to ``repro_torch.exec`` through a lazy PEP 562
``__getattr__``, as in the reference.  ``exec`` imports nothing of
``dynamic``: the backward (``transpose_plan``, ``_sddmm_grads``) writes a
plan's values into the transpose structure with ``update_values``, which
lives in ``core.values`` (``repro_torch.dynamic`` re-exports it), so
``dynamic`` may import ``exec``, as the reference's does.

Two seams must point downward only.  The tuner (``core/tuner.py``)
persists its table through ``PlanRegistry``, two layers up: ``core``
defines ``install_store`` and ``dynamic/tuning.py`` hands the store
down, so ``install_store(...)`` may be called only from ``dynamic`` and
``serve``.  The fault seams (``HARNESS.fire(...)``) fire in ``exec``,
``dynamic`` and ``serve``; nothing in ``core`` or ``kernels`` fires one.

Beyond the layers, the port stands alone: any import of ``jax``,
``jaxlib`` or the JAX package ``repro`` in the port (or in
``chip_smoke.py``) is a violation.

Usage: python tools/check_layers_torch.py  (exit 1 on violation)
"""
from __future__ import annotations

import ast
import os
import sys
from typing import Iterator, List, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = "repro_torch"
# files outside the package held to the stand-alone rule
EXTRA_FILES = (os.path.join(ROOT, "chip_smoke.py"),)
# roots the port must never import
FOREIGN = ("jax", "jaxlib", "repro")

_ABOVE_CORE = ("repro_torch.exec", "repro_torch.dynamic",
               "repro_torch.sparse", "repro_torch.models",
               "repro_torch.interop", "repro_torch.serve",
               "repro_torch.examples")

# package -> layers it must never import (prefix match on absolute module)
FORBIDDEN = {
    "errors": ("repro_torch",),
    "obs": ("repro_torch",),
    "robust": ("repro_torch",),
    "checkpoint": ("repro_torch",),
    "kernels": ("repro_torch.core", "repro_torch.data") + _ABOVE_CORE,
    "core": _ABOVE_CORE + ("repro_torch.data",),
    "exec": _ABOVE_CORE[1:] + ("repro_torch.data",),
    "dynamic": _ABOVE_CORE[2:],
    "data": _ABOVE_CORE[2:],
    "sparse": _ABOVE_CORE[3:],
    "models": _ABOVE_CORE[4:],
    "interop": _ABOVE_CORE[5:],
    "serve": _ABOVE_CORE[6:],
}

# the tuner's store hook may only be *called* from these layers, and no
# fault seam may fire in these (see the module docstring)
STORE_SEAM_HOOK = "install_store"
STORE_SEAM_CALLERS = ("dynamic", "serve")
FAULT_SEAM_HOOK = "fire"
NO_FAULT_SEAMS = ("core", "kernels")

# prefixes a package may import despite the rules above
ALLOWED_PREFIXES = {
    "obs": ("repro_torch.obs",),
    "checkpoint": ("repro_torch.checkpoint",),
    "robust": ("repro_torch.errors", "repro_torch.obs", "repro_torch.robust"),
    "kernels": ("repro_torch.core.cost_model", "repro_torch.core.plan_ir"),
}

# (module path relative to src, imported target) pairs allowed despite the
# rules above; justified in the module docstring
ALLOWED = {
    ("repro_torch/core/spmm.py", "repro_torch.exec"),
}


def _resolve_relative(module_path: str, level: int, name: str) -> str:
    """Absolute module of a ``from ..x import y`` seen in ``module_path``."""
    pkg_parts = module_path.split("/")[:-1]
    base = pkg_parts[: len(pkg_parts) - (level - 1)] if level > 1 else pkg_parts
    return ".".join(base + ([name] if name else [])).rstrip(".")


def iter_imports(module_rel: str, tree: ast.AST) -> Iterator[Tuple[int, str]]:
    """Yield (lineno, absolute module target) for every import in the AST."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module or ""
            elif node.module:
                yield node.lineno, _resolve_relative(
                    module_rel, node.level, node.module)
            else:  # ``from .. import sparse``: each name is a module
                for alias in node.names:
                    yield node.lineno, _resolve_relative(
                        module_rel, node.level, alias.name)
        elif isinstance(node, ast.Call):
            func = node.func
            name = (func.attr if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name) else None)
            if (name in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                yield node.lineno, node.args[0].value


def iter_calls(tree: ast.AST, name: str) -> Iterator[int]:
    """Line numbers of calls to a function or method named ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            called = (func.attr if isinstance(func, ast.Attribute)
                      else func.id if isinstance(func, ast.Name) else None)
            if called == name:
                yield node.lineno


def _seam_violations(rel: str, subpkg: str, tree: ast.AST) -> List[str]:
    out = []
    if subpkg not in STORE_SEAM_CALLERS:
        out += [f"{rel}:{line}: {STORE_SEAM_HOOK}() may only be called "
                f"from {'/'.join(STORE_SEAM_CALLERS)} (the tuner's store "
                f"seam points downward only)"
                for line in iter_calls(tree, STORE_SEAM_HOOK)]
    if subpkg in NO_FAULT_SEAMS:
        out += [f"{rel}:{line}: {subpkg} must not fire a fault seam"
                for line in iter_calls(tree, FAULT_SEAM_HOOK)]
    return out


def _foreign(target: str) -> bool:
    return target.split(".")[0] in FOREIGN


def _layer_violations(rel: str, subpkg: str,
                      imports: Sequence[Tuple[int, str]]) -> List[str]:
    rules = FORBIDDEN.get(subpkg, ())
    out = []
    for lineno, target in imports:
        if not target.startswith(PKG + "."):
            continue
        if any(target.startswith(p)
               for p in ALLOWED_PREFIXES.get(subpkg, ())):
            continue
        for forbidden in rules:
            if target == forbidden or target.startswith(forbidden + "."):
                if (rel, target) not in ALLOWED:
                    out.append(
                        f"{rel}:{lineno}: {subpkg} must not import {target} "
                        f"(layering: {forbidden} sits above {subpkg})")
                break
    return out


def _parse(path: str, rel: str, violations: List[str]):
    with open(path, encoding="utf-8") as f:
        try:
            return ast.parse(f.read(), filename=path)
        except SyntaxError as e:
            violations.append(f"{rel}: unparseable ({e})")
            return None


def check_tree(src_root: str = SRC,
               extra_files: Sequence[str] = EXTRA_FILES) -> List[str]:
    violations: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(os.path.join(src_root, PKG)):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, src_root).replace(os.sep, "/")
            part = rel.split("/")[1]
            # top-level modules (repro_torch/errors.py) match by stem
            subpkg = part[:-3] if part.endswith(".py") else part
            tree = _parse(path, rel, violations)
            if tree is None:
                continue
            imports = list(iter_imports(rel, tree))
            violations += [f"{rel}:{line}: imports {t} (the port imports "
                           f"no JAX and nothing of the JAX package)"
                           for line, t in imports if _foreign(t)]
            violations += _layer_violations(rel, subpkg, imports)
            violations += _seam_violations(rel, subpkg, tree)
    for path in extra_files:
        rel = os.path.basename(path)
        tree = _parse(path, rel, violations)
        if tree is not None:
            violations += [f"{rel}:{line}: imports {t} (the port imports no "
                           f"JAX and nothing of the JAX package)"
                           for line, t in iter_imports(rel, tree)
                           if _foreign(t)]
    return violations


def main() -> int:
    violations = check_tree()
    if violations:
        print("import-layering violations:", file=sys.stderr)
        for v in violations:
            print(f"  {v}", file=sys.stderr)
        return 1
    print("import layering ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
