"""Guards on the port's boundaries: it never imports jax or the reference
package, and its kernels build only from the sources in the checkout."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "ml_dtypes"), \
            f"{path.relative_to(ROOT)} imports {mod}"
    text = path.read_text()
    for needle in ("import jax", "from jax", "import repro\n", "from repro.",
                   "from repro import", "import repro."):
        assert needle not in text, f"{path.relative_to(ROOT)} contains {needle!r}"


def test_every_kernel_has_a_source_and_plain_version():
    from repro_torch.kernels import LAUNCHES, build
    for name in LAUNCHES:
        assert (build.CSRC / f"{name}.cu").exists()
    assert set(build.KERNELS) == set(LAUNCHES)
    from repro_torch.kernels.ops import KERNELS, PLAIN
    assert KERNELS.pofx_matmul is not PLAIN.pofx_matmul


def test_build_dir_is_keyed_on_sources_and_ignored():
    from repro_torch.kernels import build
    d = build.build_dir()
    assert d.parent == ROOT / "build" / "repro_torch"
    assert len(d.name) == 16
    assert "build/" in (ROOT / ".gitignore").read_text().split()
