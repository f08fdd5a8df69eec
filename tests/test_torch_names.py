"""Name parity of the port: for every module of zkevm_circuits_tpu/, its
public top-level names (def, class, module assignments, and the names an
__init__.py re-exports) exist in the port's module of the same path.  What
is left out by design is listed below, each with its reason.  The check is
static (ast): neither package is imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "zkevm_circuits_tpu"
PORT = ROOT / "zkevm_circuits_tpu_torch"

# modules of the JAX package that the port leaves out by design
LEFT_OUT_MODULES = {
    "ops/pallas_field.py": "Pallas TPU kernels K1-K4; the port's are csrc/field.cu",
    "ops/pallas_curve.py": "Pallas TPU kernels K5-K6; the port's are csrc/curve.cu",
    "crypto/hostcore.py": "ctypes binding of the JAX tree's native library",
    "plonk/quotient_native.py": "the native library's quotient evaluator for the JAX CPU backend",
    "utils/cache.py": "JAX's persistent compilation cache",
}

# JAX-only names of modules the port has
LEFT_OUT_NAMES = {
    "crypto/field.py": {
        "MASK": "digit mask of the JAX field's MXU convolution layout",
        "M_FULL": "MXU convolution matrix, JAX-only",
        "M_FULL2": "MXU convolution matrix, JAX-only",
        "M_LO": "MXU convolution matrix, JAX-only",
    },
    "poly/ntt.py": {"HOST_MIN_K": "k from which the JAX CPU backend routes NTTs to the native library"},
    "poly/ntt_mxu.py": {"RED_D": "the MXU DFT's reduction depth, JAX-only"},
    "poly/msm.py": {"F": "the module-level Fq handle of the JAX MSM"},
}


def public_names(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                names.update(e.id for e in ast.walk(target) if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                 if str(p.relative_to(REF)) not in LEFT_OUT_MODULES)


def test_left_out_lists_are_current():
    """Every exclusion names a module or a name the JAX package has."""
    for rel in LEFT_OUT_MODULES:
        assert (REF / rel).exists(), rel
        assert not (PORT / rel).exists(), rel
    for rel, names in LEFT_OUT_NAMES.items():
        assert set(names) <= public_names(REF / rel), rel


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_every_public_name(rel):
    assert (PORT / rel).exists(), f"the port has no {rel}"
    missing = public_names(REF / rel) - public_names(PORT / rel) \
        - set(LEFT_OUT_NAMES.get(rel, {}))
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"


def test_service_reexports():
    from zkevm_circuits_tpu_torch.service import ChunkProver, Proof
    from zkevm_circuits_tpu_torch.service.prover import ChunkProver as C, Proof as P

    assert (ChunkProver, Proof) == (C, P)
