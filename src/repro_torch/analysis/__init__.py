"""Static verification of the bridge's route programs.

The port's copy of the program verifier of ``repro.analysis``
(``findings`` and ``program_check``; plain numpy on the host):
:func:`check_program` gates ``ControlPlane.route_program`` behind
``verify=True``.  Rule ids and messages are the reference's.
"""
from repro_torch.analysis.findings import (ERROR, WARNING,  # noqa: F401
                                           Finding, ProgramVerificationError,
                                           errors)
from repro_torch.analysis.program_check import (  # noqa: F401
    check_program, check_transfer_window, coverage, verify_program)
