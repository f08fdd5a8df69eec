"""Rules of the port, checked statically: no file of
zkevm_circuits_tpu_torch/, chip_smoke.py or msm_state_timing.py imports
JAX or the JAX package, or loads the JAX tree's native library; every
module imports without a card or a compiler; the kernel build directory
is git-ignored; each kernel source names the TPU kernel it replaces."""

import ast
import importlib
import os
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "zkevm_circuits_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "msm_state_timing.py"]
FORBIDDEN = ("jax", "jaxlib", "zkevm_circuits_tpu")


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_rules_cover_every_subpackage():
    """parallel/ (the sharded prover) is held to the same rules."""
    for sub in ("crypto", "ops", "parallel", "plonk", "poly", "service"):
        assert any(p.parent == PKG / sub for p in FILES), sub


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_native_library(path):
    text = path.read_text()
    assert "libzkevm_native" not in text and "native/" not in text, path


@pytest.mark.parametrize(
    "module",
    sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    ),
)
def test_modules_import_without_card(module):
    importlib.import_module(module)


def test_kernel_build_dir_is_gitignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "build/torch_kernels/" in lines
    from zkevm_circuits_tpu_torch.ops import build

    assert os.path.relpath(build.BUILD_DIR, ROOT) == os.path.join("build", "torch_kernels")


@pytest.mark.parametrize("src", sorted((PKG / "csrc").glob("*.cu")), ids=lambda p: p.name)
def test_kernel_sources_name_their_tpu_kernel(src):
    text = src.read_text()
    assert "zkevm_circuits_tpu/ops/pallas_" in text
    assert "bound" in text
