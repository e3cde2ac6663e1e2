"""The port's serving image (ssdx_torch/serve/Dockerfile) checked without a
Docker daemon by ssdx_torch/tools/check_docker_context.py: the shipped
Dockerfile passes; a missing COPY source, a copied module that imports
the JAX package's stack and a ``.dockerignore`` that lets the host's builds
into the image are each caught."""
from pathlib import Path

import pytest

from ssdx_torch.tools import check_docker_context as cdc

REPO = Path(__file__).resolve().parents[1]


def _context(tmp_path: Path, dockerfile: str, files: dict[str, str]) -> Path:
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(text)
    (tmp_path / "Dockerfile").write_text(dockerfile)
    (tmp_path / ".dockerignore").write_text("\n".join(cdc.MUST_EXCLUDE) + "\n")
    return tmp_path / "Dockerfile"


def test_port_dockerfile_passes(capsys):
    assert cdc.check() == []
    assert cdc.main([]) == 0
    assert capsys.readouterr().out.startswith("ok: ")


def test_port_dockerfile_copies_the_data_files_not_the_jax_code():
    srcs = cdc.copy_sources(cdc.DOCKERFILE)
    assert "ssdx_torch/" in srcs
    assert {s for s in srcs if s.startswith("ssdx/")} == {
        "ssdx/serve/demo_weights.npz", "ssdx/serve/static/"}
    text = cdc.DOCKERFILE.read_text()
    assert 'CMD ["python", "-m", "ssdx_torch.serve.app"]' in text
    assert "FROM nvidia/cuda:" in text and "-devel-" in text  # nvcc builds the kernels


def test_missing_copy_source_is_caught(tmp_path):
    df = _context(tmp_path, "FROM scratch\nCOPY pkg/ ./pkg/\nCOPY absent.npz ./x.npz\n",
                  {"pkg/__init__.py": "import torch\n"})
    assert cdc.check(df, tmp_path) == ["missing build-context source: absent.npz"]
    assert cdc.main(["--dockerfile", str(df), "--context", str(tmp_path)]) == 1


@pytest.mark.parametrize("line,mod", [
    ("import jax.numpy as jnp", "jax.numpy"),
    ("from flax import linen", "flax"),
    ("import optax", "optax"),
    ("from ssdx.model import SSD300", "ssdx.model"),
    ("def f():\n    import ssdx\n", "ssdx"),
])
def test_copied_module_importing_the_jax_stack_is_caught(tmp_path, line, mod):
    df = _context(tmp_path, "FROM scratch\nCOPY --chown=1 pkg/ ./pkg/\n",
                  {"pkg/__init__.py": "", "pkg/sub/mod.py": line + "\n"})
    assert cdc.check(df, tmp_path) == [f"pkg/sub/mod.py imports {mod}"]


def test_the_port_and_relative_imports_are_allowed(tmp_path):
    df = _context(tmp_path, "FROM scratch\nCOPY pkg/mod.py ./pkg/\n",
                  {"pkg/mod.py": "import ssdx_torch.ops\nfrom . import jax\nimport jaxlib_free\n"})
    assert cdc.check(df, tmp_path) == []


@pytest.mark.parametrize("left_in", cdc.MUST_EXCLUDE)
def test_dockerignore_must_leave_out_the_host_builds(tmp_path, left_in):
    df = _context(tmp_path, "FROM scratch\nCOPY pkg/ ./pkg/\n", {"pkg/__init__.py": ""})
    kept = [p for p in cdc.MUST_EXCLUDE if p != left_in]
    (tmp_path / ".dockerignore").write_text("# comment\n" + "\n".join(f"/{p}/" for p in kept))
    assert cdc.check(df, tmp_path) == [f".dockerignore does not leave out {left_in}"]


def test_repo_dockerignore_leaves_out_the_host_builds():
    assert set(cdc.MUST_EXCLUDE) <= cdc.ignore_patterns(REPO / ".dockerignore")


def test_jax_package_image_fails_the_port_check():
    # the JAX package's own image copies its code, which the port's must not
    faults = cdc.check(REPO / "ssdx" / "serve" / "Dockerfile", REPO)
    assert faults and all(" imports " in f for f in faults)
    assert any(f.startswith("ssdx/model.py imports ") for f in faults)
