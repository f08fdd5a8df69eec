"""The sparse Poseidon-Merkle trie (port of zkevm_circuits_tpu/trie/)."""

from .zktrie import ZkTrie, verify_proof  # noqa: F401
