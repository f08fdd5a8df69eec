"""Recursion / aggregation layer (reference `aggregator` crate +
snark-verifier, SURVEY.md §2.1 item 10 and §2.3 item 4).

Port of zkevm_circuits_tpu/recursion/: the same modules, names and data
layout."""
