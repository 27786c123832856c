"""The paper's proof-of-concept model (§IV.A), PyTorch port: kept here
for existing callers; the model lives in :mod:`repro_torch.poc`."""

from repro_torch.poc import (  # noqa: F401
    DEFAULT_ITERS,
    INCREMENT,
    PAPER_ITERS,
    SET,
    SET_VALUE,
    build_program,
    build_registry,
    increment_body,
    initial_state,
    make_program,
    reference_final_sum,
    s_max,
    schedule_poc_events,
)
