"""The import check: nothing a run loads, and nothing the reference
imports, may be JAX or the JAX package.

Module names are compared by their top-level name, the part before the
first dot, whole: ``airpose_tpu_torch`` (the system under test) begins with
``airpose_tpu`` (the JAX package) and must not be mistaken for it.
"""

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "airpose_tpu"})
PROGRAM = "airpose_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str], also=()) -> List[str]:
    """The names whose top-level name is forbidden (or in ``also``)."""
    bad = FORBIDDEN | frozenset(also)
    return sorted({n for n in names if top(n) in bad})


def loaded_forbidden() -> List[str]:
    """Forbidden modules in this process's ``sys.modules``."""
    return forbidden(list(sys.modules))


def reference_imports(directory: Path = REFERENCE_DIR) -> List[str]:
    """Every module the reference's sources import (absolute imports; the
    relative ones stay inside the reference)."""
    names = []
    for path in sorted(directory.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names.append(node.module)
    return names


def reference_forbidden() -> List[str]:
    """What the reference imports of JAX, the JAX package or the program."""
    return forbidden(reference_imports(), also=(PROGRAM,))
