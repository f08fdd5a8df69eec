"""testool — state-test CLI and library (port of
zkevm_circuits_tpu/testool/).

Equivalent of the reference's `testool/` crate (SURVEY.md §2.1 item 13):
runs Ethereum GeneralStateTests fillers and one-liner specs through the
tracer -> builder -> circuit pipeline at configurable depth
(trace / witness / mock), checks post-state expectations, and reports.
"""

from .statetest import (  # noqa: F401
    AccountState, CircuitsConfig, StateTest, StateTestResult, run_state_test,
)
from .oneliner import parse_oneliner  # noqa: F401
from .json_parser import load_json_fillers  # noqa: F401
