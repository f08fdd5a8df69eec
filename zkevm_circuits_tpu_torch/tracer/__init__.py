"""In-repo EVM tracer — the geth-utils/external-tracer equivalent.

The reference embeds Go geth behind CGO to produce `GethExecTrace`s
(`geth-utils/l2geth/lib.go`, SURVEY.md §2.3 item 2).  Here the tracer is
an in-repo interpreter emitting the identical JSON schema, so real geth
traces remain ingestible interchangeably.

Port of zkevm_circuits_tpu/tracer/__init__.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from .evm import Interpreter, StateDB, Account, BlockEnv, Tx  # noqa: F401
