"""Resilience: failure detection, plan repair, recovery, speculation.

The paper sells TeShu as a shuffle *service* that keeps working when the data
center misbehaves (§5.2 link failures, §6 participant-subset restart).  This
package is that story as an end-to-end execution path rather than
bandwidth-degradation arithmetic:

* :mod:`.detector` — classify suspects: dead (restart) vs slow (speculate).
* :mod:`.repair` — re-derive only the affected levels of a compiled plan
  against a degraded topology; repaired plans are cached under the degraded
  fingerprint so repeated identical failures are plain cache hits.
* :mod:`.recovery` — manager-side per-stage checkpoints + journal replay
  restart the minimal participant subset with byte-identical results.
* :mod:`.speculation` — duplicate stragglers' tasks onto healthy peers.

`TeShuService(..., resilience="recover")` turns the whole pipeline on; see
``docs/resilience.md`` for the flow diagram and knobs.
"""
from .detector import FailureDetector, FailureReport
from .recovery import (Checkpoint, CheckpointStore, RecoveryContext,
                       RecoveryCoordinator, StreamCheckpoint,
                       consistent_resume_stages)
from .repair import repair_plan, try_repair
from .speculation import SpeculationPolicy, SpeculativeTask

__all__ = [
    "FailureDetector", "FailureReport", "Checkpoint", "CheckpointStore",
    "RecoveryContext", "RecoveryCoordinator", "StreamCheckpoint",
    "consistent_resume_stages",
    "repair_plan", "try_repair", "SpeculationPolicy", "SpeculativeTask",
]
