"""Core Ethereum types — the eth-types layer (SURVEY.md §2.1 item 1).

Port of zkevm_circuits_tpu/types/__init__.py: the same names, signatures and
behaviour, importing only inside zkevm_circuits_tpu_torch.
"""

from .evm import GasCost, OpcodeId  # noqa: F401
from .bytecode import Bytecode  # noqa: F401
