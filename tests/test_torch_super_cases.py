"""Port SuperCircuit against the JAX package's: the second half of the
MockProver verdict cases (see tests/test_torch_super.py, whose `twin`
runs each reference test as it is and pointed at the port, and compares
every verdict).  Fast tier: the rest of tests/test_super_circuit.py's
cases at k=9-10, the SuperCircuit cases of tests/test_nested_calldata.py
(k=12) and tests/test_evm_gas.py, and tests/test_account_machine.py's four
cases.  Slow tier (the reference slow-lists them): the k=13 cases of
tests/test_super_circuit.py and tests/test_super_mpt.py's four cases."""

import pytest
import torch

from test_torch_super import verdicts_match

torch.set_num_threads(2)

FAST_CASES = [
    ("test_super_circuit", "test_super_circuit_log_opcodes"),
    ("test_super_circuit", "test_super_circuit_catches_wrong_log_topic"),
    ("test_super_circuit", "test_super_circuit_identity_and_ecadd_precompiles"),
    ("test_super_circuit", "test_super_circuit_block_context_ops"),
    ("test_super_circuit", "test_super_circuit_blockhash_bound"),
    ("test_super_circuit", "test_super_circuit_full_catches_copy_corruption"),
    ("test_super_circuit", "test_super_circuit_sha256_precompile"),
    ("test_super_circuit", "test_super_circuit_sha256_empty_input"),
    ("test_nested_calldata", "test_padded_copy_super_composition"),
    ("test_evm_gas", "test_dynamic_gas_copies_log_composed"),
    ("test_account_machine", "test_begin_end_tx_account_rows_prove"),
    ("test_account_machine", "test_account_opcodes_prove"),
    ("test_account_machine", "test_failed_tx_reverts_value_transfer"),
    ("test_account_machine", "test_wrong_account_value_rejected"),
]


@pytest.mark.parametrize("mod,test", FAST_CASES, ids=[t for _, t in FAST_CASES])
def test_mock_verdicts_match_reference(mod, test):
    verdicts_match(mod, test)


SLOW_CASES = [
    ("test_super_circuit", "test_super_circuit_full_composition"),
    ("test_super_circuit", "test_super_circuit_ecmul_precompile"),
    ("test_super_circuit", "test_super_circuit_ecrecover_precompile"),
    ("test_super_circuit", "test_super_circuit_catches_wrong_sha3_digest"),
    ("test_super_circuit", "test_super_circuit_with_sig_binding"),
    ("test_super_circuit", "test_super_circuit_sig_catches_wrong_sender"),
    ("test_super_circuit", "test_super_circuit_modexp_precompile"),
    ("test_super_circuit", "test_super_circuit_create_keccak_bound"),
    ("test_super_mpt", "test_super_two_level_composed"),
    ("test_super_mpt", "test_super_two_level_hidden_write_rejected"),
    ("test_super_mpt", "test_super_pi_binds_state_roots"),
    ("test_super_mpt", "test_super_pi_derives_data_hash"),
]


@pytest.mark.slow
@pytest.mark.parametrize("mod,test", SLOW_CASES, ids=[t for _, t in SLOW_CASES])
def test_k13_mock_verdicts_match_reference(mod, test):
    verdicts_match(mod, test)
