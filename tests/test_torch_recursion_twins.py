"""The reference's recursion tests run twice: as they are, and as their port
twin (tests/test_torch_super.py::twin: the same source with every import of
the JAX package pointed at the port), the twin's entry points on the CPU.
Every verdict either run reaches is recorded in order: each MockProver's
failure list, and the result of verify, finish_deferred,
fold_and_verify_claims, verify_fold, verify_layer1 and evm_verify,
wherever in the package or the test they are called.  The two lists must
be equal.

This file holds the fast tier's twins, tests/test_batch_hash.py and
tests/test_evm_verifier.py.  The reference side of test_evm_verifier runs
on the port's proof (its `artifact` fixture is a k=5 prove, minutes from
the JAX package on the CPU; the port's proofs equal the reference's,
plonk/demo.py's goldens): the reference's gen_verifier_artifact writes its
artifact from the reference's constraint system and the port's commitments.
tests/test_torch_recursion_slow.py holds the slow tier's twins."""

import contextlib
import importlib
import inspect
import os
import pkgutil
import sys

import pytest
from test_torch_super import twin

import zkevm_circuits_tpu_torch
from zkevm_circuits_tpu_torch import device as tdevice

VERDICTS = {
    "plonk.verifier": ("verify",),
    "recursion.compression": ("finish_deferred",),
    "recursion.aggregation": ("fold_and_verify_claims",),
    "recursion.fold": ("verify_fold",),
    "recursion.layer": ("verify_layer1",),
    "recursion.evm_verifier": ("evm_verify",),
}
PORT = "zkevm_circuits_tpu_torch"
REFERENCE = "zkevm_circuits_tpu"


def _modules(pkg: str) -> list:
    """The loaded modules of package `pkg` and the test modules (reference
    tests and their twins)."""
    return [m for name, m in list(sys.modules.items()) if m is not None and (
        name == pkg or name.startswith(pkg + ".") or name.startswith(("test_", "torch_twin_")))]


@contextlib.contextmanager
def _rebound(mods: list, table: dict):
    """Every global of `mods` that is, by identity, the first item of a
    value of `table` (keyed by its id) bound to the second, until exit."""
    undo = []
    for m in mods:
        for attr, val in list(vars(m).items()):
            new = table.get(id(val))
            if new is not None and new[0] is val:
                undo.append((m, attr, val))
                setattr(m, attr, new[1])
    try:
        yield
    finally:
        for m, attr, val in reversed(undo):
            setattr(m, attr, val)


@contextlib.contextmanager
def recording(pkg: str, seen: list):
    """Append each verdict reached in package `pkg` or a test to `seen`."""
    table = {}
    for sub, names in VERDICTS.items():
        mod = importlib.import_module(f"{pkg}.{sub}")
        for name in names:
            f = getattr(mod, name)

            def rec(*a, _f=f, _name=name, **kw):
                out = _f(*a, **kw)
                seen.append((_name, bool(out)))
                return out

            table[id(f)] = (f, rec)
    mock = importlib.import_module(f"{pkg}.plonk.mock").MockProver
    base = mock.verify

    def verify(self):
        out = base(self)
        seen.append(("mock", list(out)))
        return out

    mock.verify = verify
    try:
        with _rebound(_modules(pkg), table):
            yield
    finally:
        mock.verify = base


@contextlib.contextmanager
def port_on_cpu():
    """The port's entry points on the CPU when the caller names no device
    (the reference's tests name none)."""
    for info in pkgutil.walk_packages(zkevm_circuits_tpu_torch.__path__, PORT + "."):
        importlib.import_module(info.name)
    orig = tdevice.resolve

    def resolve(device=None):
        return orig("cpu" if device is None else device)

    with _rebound(_modules(PORT), {id(orig): (orig, resolve)}):
        yield


_FIXTURES: dict = {}
# reference fixtures taken from elsewhere: (module, fixture) -> function of
# the run's context returning the fixture's value
REFERENCE_FIXTURES: dict = {}


def _fixture(mod, name: str, ctx: dict):
    if name in ctx:
        return ctx[name]
    key = (mod.__name__, name)
    if key not in _FIXTURES:
        if key in REFERENCE_FIXTURES:
            _FIXTURES[key] = REFERENCE_FIXTURES[key](ctx)
        else:
            fx = getattr(mod, name)
            fn = (fx._get_wrapped_function() if hasattr(fx, "_get_wrapped_function")
                  else getattr(getattr(fx, "__pytest_wrapped__", None), "obj", fx))
            _FIXTURES[key] = _call(mod, fn, ctx)
    return _FIXTURES[key]


def _call(mod, fn, ctx: dict):
    return fn(**{p: _fixture(mod, p, ctx) for p in inspect.signature(fn).parameters})


def run_recording(mod, test: str, pkg: str, tmp_path_factory) -> list:
    """Run mod.<test> (its fixtures resolved, module ones once) and return
    the verdicts it reached."""
    seen: list = []
    with recording(pkg, seen), pytest.MonkeyPatch.context() as mp:
        ctx = {"monkeypatch": mp, "tmp_path_factory": tmp_path_factory,
               "tmp_path": tmp_path_factory.mktemp(f"{pkg}_{test}")}
        _call(mod, getattr(mod, test), ctx)
    return seen


def verdicts_match(modname: str, test: str, tmp_path_factory) -> list:
    """The port twin of tests/<modname>.py::<test> and the test itself
    pass, with the same verdicts in the same order (none, for a test of
    host values only); those verdicts."""
    with port_on_cpu():
        got = run_recording(twin(modname), test, PORT, tmp_path_factory)
    want = run_recording(importlib.import_module(modname), test, REFERENCE,
                         tmp_path_factory)
    assert got == want
    return got


def _tests_of(modname: str) -> list[str]:
    mod = importlib.import_module(modname)
    return [n for n, f in vars(mod).items() if n.startswith("test_") and callable(f)]


# ---------------------------------------------------------------------------
# the reference side of test_evm_verifier on the port's proof

def _reference_artifact(ctx: dict):
    """tests/test_evm_verifier.py's `artifact` for the reference: the
    port twin's proof, and the reference's artifact for the same vk."""
    from test_plonk_prove import DemoCircuit as JDemo

    from zkevm_circuits_tpu.plonk.circuit import ConstraintSystem as JCS
    from zkevm_circuits_tpu.plonk.keygen import VerifyingKey as JVK
    from zkevm_circuits_tpu.recursion.evm_verifier import gen_verifier_artifact

    _, proof = _fixture(twin("test_evm_verifier"), "artifact", ctx)
    vk = _PORT_ARTIFACT_VK[0]
    jcs = JCS()
    JDemo().configure(jcs)
    jvk = JVK(k=vk.k, cs=jcs, fixed_commitments=list(vk.fixed_commitments),
              sigma_commitments=list(vk.sigma_commitments), g2=vk.g2, s_g2=vk.s_g2)
    path = str(ctx["tmp_path_factory"].mktemp("artifact_reference") / "verifier_demo.py")
    gen_verifier_artifact(jvk, path)
    return path, proof


REFERENCE_FIXTURES[("test_evm_verifier", "artifact")] = _reference_artifact
_PORT_ARTIFACT_VK: list = []


@pytest.fixture(scope="module")
def capture_artifact_vk():
    """Keep the vk the port twin's `artifact` fixture writes its artifact
    for (the reference side's artifact is written for the same vk)."""
    from zkevm_circuits_tpu_torch.recursion import evm_verifier as tev

    orig = tev.gen_verifier_artifact

    def capture(vk, path, *a, **kw):
        _PORT_ARTIFACT_VK.append(vk)
        return orig(vk, path, *a, **kw)

    port = twin("test_evm_verifier")
    with _rebound([port], {id(orig): (orig, capture)}):
        yield


@pytest.mark.parametrize("test", _tests_of("test_batch_hash"))
def test_batch_hash_twin(test, tmp_path_factory):
    assert verdicts_match("test_batch_hash", test, tmp_path_factory)


@pytest.mark.parametrize("test", _tests_of("test_evm_verifier"))
def test_evm_verifier_twin(test, tmp_path_factory, capture_artifact_vk):
    got = verdicts_match("test_evm_verifier", test, tmp_path_factory)
    assert got and all(name == "evm_verify" for name, _ in got)


def test_artifacts_embed_the_same_vk(tmp_path_factory, capture_artifact_vk):
    """The port's and the reference's artifacts for the twin's vk carry the
    same serialized vk and parameters, and import only the stdlib."""
    import re

    port = twin("test_evm_verifier")
    with port_on_cpu():
        port_path, _ = _fixture(port, "artifact", {"tmp_path_factory": tmp_path_factory})
    ref_path, _ = _fixture(importlib.import_module("test_evm_verifier"), "artifact",
                           {"tmp_path_factory": tmp_path_factory})
    texts = [open(p).read() for p in (port_path, ref_path)]
    assert os.path.getsize(port_path) > 10_000
    for src in texts:
        assert set(re.findall(r"^(?:import|from)\s+([\w.]+)", src, re.M)) <= \
            {"hashlib", "json", "sys"}
    vk_lines = [[ln for ln in src.splitlines() if ln.startswith(("VK = ", "ACC = ", "FR_MODULUS"))]
                for src in texts]
    assert vk_lines[0] == vk_lines[1] and len(vk_lines[0]) == 3
