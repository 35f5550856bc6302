"""What a benchmark run may not load.

Names are compared by their top level, the part before the first dot,
whole: ``vct_torch`` is the program and passes, ``vct`` (the JAX package)
and ``vct.models`` do not.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

__all__ = ["FORBIDDEN", "REFERENCE_FORBIDDEN", "loaded_forbidden", "imports_forbidden"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vct"})
# The reference may not reach the program either.
REFERENCE_FORBIDDEN = FORBIDDEN | {"vct_torch"}


def loaded_forbidden(forbidden=FORBIDDEN, modules=None) -> list:
    """Loaded module names whose top level is in ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if n.split(".", 1)[0] in forbidden)


def imports_forbidden(directory: Path, forbidden=REFERENCE_FORBIDDEN) -> list:
    """"file:line name" for every import statement under ``directory``,
    at any depth in the code, whose top-level name is in ``forbidden``."""
    found = []
    for path in sorted(Path(directory).rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if n.split(".", 1)[0] in forbidden]
    return found
