"""The decision record the serve controller logs.

The port's copy of ``Decision`` from ``horovod_tpu/common/autoscale.py``
(the training autoscaler itself is not ported yet): the serve plane's
decision log shares its ``{"seq", "action", "target", "reason"}``
JSON-lines form, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class Decision:
    """One engine decision. ``seq`` counts NON-KEEP decisions (the
    deterministic decision-log sequence); keeps carry seq 0."""

    action: str
    target: Optional[str] = None
    reason: str = ""                # stable code, not measured numbers
    permanent: bool = False
    ttl_s: Optional[float] = None
    seq: int = 0
    role: Optional[str] = None

    def log_line(self) -> str:
        """Deterministic JSON-lines form — no timestamps, no measured
        floats, so a seeded run's log repeats byte for byte."""
        d = {"seq": self.seq, "action": self.action,
             "target": self.target, "reason": self.reason}
        if self.role is not None:
            d["role"] = self.role
        return json.dumps(d, sort_keys=True)
