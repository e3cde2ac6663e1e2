"""Check the port's serving image without a Docker daemon.

    python -m ssdx_torch.tools.check_docker_context [--dockerfile PATH] [--context DIR]

The counterpart of ``scripts/check_docker_context.py``, for
``ssdx_torch/serve/Dockerfile``: every COPY/ADD source must exist in the
build context (the repository root), and no Python file that a COPY/ADD
brings into the image may import ``jax``, ``flax``, ``optax`` or the JAX
package ``ssdx`` (the image holds the port alone; the JAX package's data
files may be copied, its code may not).  The context's ``.dockerignore`` must
leave out what a checkout builds or writes locally (``MUST_EXCLUDE``), so
that the image does not depend on the machine that builds it.  Exit 0 when
all of this holds, 1 otherwise, with one line for each fault.
"""
from __future__ import annotations

import argparse
import ast
import shlex
import sys
from pathlib import Path

__all__ = ["copy_sources", "forbidden_imports", "ignore_patterns", "check", "main"]

REPO = Path(__file__).resolve().parents[2]
DOCKERFILE = REPO / "ssdx_torch" / "serve" / "Dockerfile"
FORBIDDEN = ("jax", "flax", "optax", "ssdx")
# the kernels built on the host, the port's local demo bundle (served in
# preference to the JAX package's), Python caches
MUST_EXCLUDE = ("ssdx_torch/_build", "ssdx_torch/serve/demo_weights.npz", "**/__pycache__")


def copy_sources(dockerfile: Path) -> list[str]:
    """The source operands of every COPY/ADD (all operands but the last;
    ``--flag`` options skipped)."""
    sources: list[str] = []
    lines = [ln.strip() for ln in dockerfile.read_text().splitlines()]
    text = "\n".join(ln for ln in lines if not ln.startswith("#"))
    for line in text.replace("\\\n", " ").splitlines():  # join continued lines
        if not line:
            continue
        parts = shlex.split(line)
        if parts and parts[0].upper() in ("COPY", "ADD"):
            operands = [p for p in parts[1:] if not p.startswith("--")]
            sources.extend(operands[:-1])
    return sources


def forbidden_imports(path: Path) -> list[str]:
    """The modules of ``FORBIDDEN`` (or their submodules) that a Python file
    imports, anywhere in it; relative imports are the package's own."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def ignore_patterns(dockerignore: Path) -> set[str]:
    """The patterns of a ``.dockerignore`` (none when it is absent), without
    a leading or trailing ``/``."""
    if not dockerignore.exists():
        return set()
    lines = (ln.strip() for ln in dockerignore.read_text().splitlines())
    return {ln.strip("/") for ln in lines if ln and not ln.startswith("#")}


def _matches(context: Path, src: str) -> list[Path]:
    path = context / src
    return [path] if path.exists() else sorted(context.glob(src))


def check(dockerfile: Path = DOCKERFILE, context: Path = REPO) -> list[str]:
    """Every fault of ``dockerfile`` in ``context``, as lines (none = ok)."""
    ignored = ignore_patterns(context / ".dockerignore")
    faults = [f".dockerignore does not leave out {p}" for p in MUST_EXCLUDE if p not in ignored]
    for src in copy_sources(dockerfile):
        if src.startswith(("http://", "https://")):
            faults.append(f"remote source {src}: the image must build from the context")
            continue
        hits = _matches(context, src)
        if not hits:
            faults.append(f"missing build-context source: {src}")
        for hit in hits:
            files = sorted(hit.rglob("*.py")) if hit.is_dir() else [hit]
            for f in files:
                if f.suffix != ".py":
                    continue
                for mod in forbidden_imports(f):
                    faults.append(f"{f.relative_to(context)} imports {mod}")
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dockerfile", type=Path, default=DOCKERFILE)
    ap.add_argument("--context", type=Path, default=REPO)
    args = ap.parse_args(argv)
    faults = check(args.dockerfile, args.context)
    for line in faults:
        print(line)
    if faults:
        return 1
    print(f"ok: every COPY/ADD source of {args.dockerfile} exists in {args.context}, "
          "no copied module imports jax, flax, optax or ssdx, and .dockerignore "
          "leaves out the host's builds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
