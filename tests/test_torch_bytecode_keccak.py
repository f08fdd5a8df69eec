"""The Bytecode circuit bound to the Keccak circuit through the code hash
(tests/test_bytecode_keccak_binding.py, k=12) in the port against the JAX
package: the MockProver verdicts on the good witness and on a wrong code
hash, exact.  The JAX package's MockProver takes about half a minute on
each, so these two cases have a file of their own."""

import pytest

from test_torch_partners import JAX, PORT, edit
from zkevm_circuits_tpu.plonk.mock import MockProver as JMock
from zkevm_circuits_tpu_torch.plonk.mock import MockProver as TMock


def _bytecode_keccak(pkg, codes, corrupt_hash):
    """tests/test_bytecode_keccak_binding.py::BytecodeKeccak: the Keccak
    sponge and the Bytecode circuit in one system, the code hash bound."""
    Circuit = pkg["circuit"].Circuit

    class BytecodeKeccak(Circuit):
        def __init__(self):
            self.keccak = pkg["keccak"].KeccakCircuit(codes)
            self.bytecode = pkg["bytecode"].BytecodeCircuit(
                [pkg["types"].Bytecode(c) for c in codes])
            self.subs = [self.keccak, self.bytecode]

        def configure(self, cs):
            r = cs.challenge(phase=0)
            self.keccak.configure(cs, challenge=r)
            self.bytecode.configure(
                cs, challenge=r, keccak_table=self.keccak.keccak_table_exprs())

        def fixed_columns(self, n):
            out = {}
            for s in self.subs:
                out.update(s.fixed_columns(n))
            return out

        def synthesize(self, phase, n, challenges, instances):
            out = {}
            for s in self.subs:
                out.update(s.synthesize(phase, n, challenges, instances))
            if corrupt_hash and phase == 1:
                # a wrong code hash on the last pad row, where the keccak
                # binding reads it
                row = 1 + len(codes[0]) + (136 - len(codes[0])) - 1
                edit(out, self.bytecode.c_hash, row, lambda v: 0xDEAD)
            return out

    return BytecodeKeccak()


@pytest.mark.parametrize("corrupt_hash", [False, True])
def test_bytecode_keccak_binding_matches_reference(corrupt_hash):
    codes = ([bytes.fromhex("6005600501" "00")] if not corrupt_hash
             else [bytes.fromhex("600550" "00")])
    k = 12
    tc, jc = _bytecode_keccak(PORT, codes, corrupt_hash), _bytecode_keccak(JAX, codes, corrupt_hash)
    got, want = TMock(k, tc).verify(), JMock(k, jc).verify()
    assert got == want
    assert bool(got) == corrupt_hash, got
    if corrupt_hash:
        assert any("code hash keccak" in f for f in got), got
