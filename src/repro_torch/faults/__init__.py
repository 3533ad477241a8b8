"""Fault injection + recovery for the AMTHA scheduler (DESIGN.md §12).

``FaultScript`` is the deterministic injection side; detection and the
transactional re-mapping live in :mod:`repro_torch.online.recovery`.
"""

from .script import (CORE_FAIL, CORE_SLOW, KINDS, LINK_DEGRADE, FaultEvent,
                     FaultScript, core_fail, core_slow, link_degrade,
                     random_script)

__all__ = [
    "CORE_FAIL", "CORE_SLOW", "LINK_DEGRADE", "KINDS",
    "FaultEvent", "FaultScript",
    "core_fail", "core_slow", "link_degrade", "random_script",
]
