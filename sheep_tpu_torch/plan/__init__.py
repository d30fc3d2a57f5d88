"""The build planner (port of sheep_tpu/plan: ``plan_build`` and the prior
store it reads).

``plan_build`` resolves one build's plan — rung order, native thread
count, ext/spill block size, handoff windows — folding the governor's
analytic prices (resources/governor.py) with measured priors learned from
past traces (plan/priors.py).  Every ``SHEEP_*`` knob is an *override*
recorded in the plan with its provenance (default | priced | learned |
forced).
"""

from .model import (DEFAULT_LADDER, PROV_DEFAULT, PROV_FORCED,
                    PROV_LEARNED, PROV_PRICED, Decision, Plan,
                    available_rungs, plan_build)
from .priors import (MIN_CORRECT_SAMPLES, PRIORS_ENV, PriorStore,
                     host_fingerprint, mem_ratio, prior_key, scale_bucket)

__all__ = [
    "DEFAULT_LADDER",
    "Decision",
    "MIN_CORRECT_SAMPLES",
    "PRIORS_ENV",
    "PROV_DEFAULT",
    "PROV_FORCED",
    "PROV_LEARNED",
    "PROV_PRICED",
    "Plan",
    "PriorStore",
    "available_rungs",
    "host_fingerprint",
    "mem_ratio",
    "plan_build",
    "prior_key",
    "scale_bucket",
]
