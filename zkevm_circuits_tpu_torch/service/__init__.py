"""Proving service layer — the reference `prover` crate equivalent (port of\nzkevm_circuits_tpu/service/)."""

from .prover import ChunkProver, Proof  # noqa: F401
